"""Host-side dataset: filelists, random segments, threaded prefetch.

The port's own copy of nvse_tpu/data/dataset.py (numpy only). The host
pipeline loads and crops raw audio segments; mel and amplitude/phase
features are computed on the device inside the train step (reference
dataset.py:158-258 computes them in DataLoader workers).

Filelist format matches the reference (LJSpeech-style
"DUMMY1/<file>.wav|<transcript>" lines resolved against
raw_wavfile_path, dataset.py:142-155). Crops are seeded per (epoch,
batch) exactly as in the JAX package, so both draw the same segments.
The JAX loader's optional C++ batch decoder (`native/`) is not carried
over: batches are decoded by the reader threads.
"""
from __future__ import annotations

import os
import queue
import random
import threading
from typing import Iterator, Sequence

import numpy as np

from .audio_io import load_wav

_CACHE_BYTES = 2 << 30


def parse_filelist_line(line: str) -> str:
    """'DUMMY1/LJ001-0001.wav|text...' -> 'LJ001-0001.wav' (dataset.py:146)."""
    return line.strip().split("/")[1].split("|")[0]


def get_dataset_filelist(train_list: str, val_list: str, wav_root: str):
    """Reference dataset.py:142-155 contract."""

    def read(p):
        with open(p) as f:
            return [os.path.join(wav_root, parse_filelist_line(l)) for l in f if l.strip()]

    return read(train_list), read(val_list)


class SegmentDataset:
    """Random fixed-length audio segments from a filelist.

    Mirrors reference Dataset.__getitem__ cropping (dataset.py:208-216):
    random segment_size crop, zero-pad short files. Returns raw audio
    only; features are computed on device.
    """

    def __init__(self, files: Sequence[str], segment_size: int, sampling_rate: int,
                 split: bool = True, shuffle: bool = True, seed: int = 1234):
        self.files = list(files)
        if shuffle:
            random.Random(seed).shuffle(self.files)
        self.segment_size = segment_size
        self.sampling_rate = sampling_rate
        self.split = split
        self.rng = random.Random(seed)
        # decoded wavs, FIFO-bounded so an LJSpeech-scale corpus cannot grow
        # it past host RAM (float32 ~7.6 GB for 24 h); the reader threads
        # share it
        self._cache: dict[str, np.ndarray] = {}
        self._cache_bytes = 0
        self._cache_lock = threading.Lock()

    def __len__(self) -> int:
        return len(self.files)

    def _load(self, path: str) -> np.ndarray:
        with self._cache_lock:
            if path in self._cache:
                return self._cache[path]
        audio = load_wav(path, self.sampling_rate)
        with self._cache_lock:
            if path not in self._cache and audio.nbytes <= _CACHE_BYTES:
                while self._cache and self._cache_bytes + audio.nbytes > _CACHE_BYTES:
                    oldest = next(iter(self._cache))  # dicts iterate FIFO
                    self._cache_bytes -= self._cache.pop(oldest).nbytes
                self._cache[path] = audio
                self._cache_bytes += audio.nbytes
        return audio

    def segment_at(self, index: int, rng: random.Random) -> np.ndarray:
        """Random crop with a CALLER-OWNED rng — the loader derives one
        per (epoch, batch) so multi-threaded prefetch stays run-to-run
        deterministic (the shared self.rng is only deterministic when
        items are drawn from a single thread)."""
        audio = self._load(self.files[index])
        if not self.split:
            return audio
        seg = self.segment_size
        if len(audio) >= seg:
            start = rng.randint(0, len(audio) - seg)
            return audio[start : start + seg]
        return np.pad(audio, (0, seg - len(audio)))

    def __getitem__(self, index: int) -> np.ndarray:
        return self.segment_at(index, self.rng)


class PrefetchLoader:
    """Threaded batching loader: shuffled epochs, drop_last, bounded queue.

    Replaces torch DataLoader(num_workers=4, shuffle, drop_last)
    (train_tf_wi_inv.py:122-130) with reader threads filling a queue of
    ready (B, segment) float32 batches.
    """

    def __init__(self, dataset: SegmentDataset, batch_size: int,
                 num_workers: int = 4, seed: int = 1234):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.epoch = 0

    def __len__(self) -> int:
        return len(self.dataset) // self.batch_size

    def __iter__(self) -> Iterator[np.ndarray]:
        order = np.random.default_rng(self.seed + self.epoch).permutation(len(self.dataset))
        epoch = self.epoch
        self.epoch += 1
        nb = len(self)
        out_q: queue.Queue = queue.Queue(maxsize=8)
        idx_q: queue.Queue = queue.Queue()
        for b in range(nb):
            idx_q.put((b, order[b * self.batch_size : (b + 1) * self.batch_size]))

        results: dict[int, np.ndarray] = {}
        lock = threading.Lock()

        def make_batch(b, idxs):
            # unique per (epoch, batch): the epoch term must out-stride
            # the largest batch index or streams repeat across epochs
            bseed = (self.seed * 1_000_003 + epoch + 1) * 1_000_003 + b
            # per-batch rng (not the dataset's shared one): worker
            # threads interleave nondeterministically, so a shared rng
            # would make crops depend on thread scheduling
            rng = random.Random(bseed)
            return np.stack([self.dataset.segment_at(int(i), rng) for i in idxs])

        def worker():
            while True:
                try:
                    b, idxs = idx_q.get_nowait()
                except queue.Empty:
                    return
                try:
                    batch = make_batch(b, idxs)
                except BaseException as e:  # propagate: a dead worker
                    batch = e               # must not hang the consumer
                with lock:
                    results[b] = batch
                out_q.put(b)

        threads = [threading.Thread(target=worker, daemon=True) for _ in range(self.num_workers)]
        for t in threads:
            t.start()

        next_b = 0
        pending: dict[int, np.ndarray] = {}
        received = 0
        while next_b < nb:
            while next_b not in pending:
                b = out_q.get()
                with lock:
                    pending[b] = results.pop(b)
                received += 1
            item = pending.pop(next_b)
            if isinstance(item, BaseException):
                raise item
            yield item
            next_b += 1
