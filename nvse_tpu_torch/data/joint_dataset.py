"""Joint denoise+vocoder dataset: task sampling + LUFS-SNR noise mixing.

The port's own copy of nvse_tpu/data/joint_dataset.py (numpy and
`random` on the host): with the same seed it draws the same batches, bit
for bit. The noise list is read as written: each line is a path, absolute
or relative to the working directory.

Host-side re-derivation of reference
dataset_joint_denoise_vocoder.py:144-407, with the TPU-first split: this
pipeline emits raw (input_wave, clean_wave, task) batches; spectral
features (noisy log-amp spectrum for denoise, log pseudo-inverse mel for
vocoder, targets) are computed on the device in the joint train step
(train/trainer.py, ops/spectral.py:joint_input).

Semantics preserved:
  * 50/50 per-batch task draw from task_dict (:229-238); the whole
    batch shares one task (the reference builds the batch inside
    __getitem__, :240-403).
  * denoise: random noise file, pre-amplified x100 (:250), tile/crop
    with near-silent-crop rejection (:266-277), LUFS-matched SNR in
    U[snr_range] (:291-301), inf/nan gain fallback 1.0, anti-clipping
    rescale loop with U(0.3, 0.9) peak target (:304-308).
  * vocoder: clean speech in == out.
  * speech shorter than the segment is tiled, not zero-padded (:263-264).
"""
from __future__ import annotations

import glob
import os
import random
from typing import Iterator, Sequence

import numpy as np

from .audio_io import load_wav
from .loudness import integrated_loudness


def get_joint_filelist(input_training_wav_list, input_validation_wav_list,
                       raw_wavfile_path, input_noise_wav_list):
    """Reference :144-175: 90/10 noise split + existence-checked speech."""
    with open(input_noise_wav_list) as f:
        noise_all = [l.strip() for l in f if l.strip()]
    n = len(noise_all)
    train_noise, val_noise = noise_all[: int(0.9 * n)], noise_all[int(0.9 * n):]

    actual = set()
    for depth in range(1, 5):
        actual.update(glob.glob(os.path.join(raw_wavfile_path, *(["*"] * (depth - 1)), "*.wav")))

    def read(p):
        out = []
        with open(p) as f:
            for l in f:
                if not l.strip():
                    continue
                name = l.strip().split("|")[0]
                # accept both scp styles: bare stem ("LJ001-0001", the
                # joint reference format) and LJSpeech filelist entries
                # ("DUMMY1/LJ001-0001.wav")
                for cand in (
                    os.path.join(raw_wavfile_path, f"{name}.wav"),
                    os.path.join(raw_wavfile_path, os.path.basename(name)),
                ):
                    if cand in actual:
                        out.append(cand)
                        break
        return out

    return read(input_training_wav_list), read(input_validation_wav_list), train_noise, val_noise


class JointDataset:
    """Yields (input_wave, clean_wave, task) batches, one task per batch."""

    def __init__(
        self,
        speech_files: Sequence[str],
        noise_files: Sequence[str],
        snr_range: tuple[float, float],
        segment_size: int,
        sampling_rate: int,
        batch_size: int,
        task_dict=("denoise", "vocoder"),
        split: bool = True,
        shuffle: bool = True,
        seed: int = 1234,
    ):
        self.speech_files = list(speech_files)
        if shuffle:
            random.Random(seed).shuffle(self.speech_files)
        self.noise_files = list(noise_files)
        self.snr_range = tuple(snr_range)
        self.segment_size = segment_size
        self.sampling_rate = sampling_rate
        self.batch_size = batch_size
        self.task_dict = task_dict
        self.split = split
        self.rng = random.Random(seed)
        self.np_rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.speech_files) // self.batch_size

    def _draw_task(self, rng) -> str:
        td = self.task_dict
        if isinstance(td, str):
            return td
        if len(td) == 1:
            return td[0]
        return td[rng.choices([0, 1], weights=[0.5, 0.5], k=1)[0]]

    def _crop_speech(self, audio: np.ndarray, seg: int, rng) -> np.ndarray:
        if len(audio) >= seg:
            start = rng.randint(0, len(audio) - seg)
            return audio[start : start + seg]
        nrep = int(np.ceil(seg / len(audio)))
        return np.tile(audio, nrep)[:seg]

    def _crop_noise(self, noise: np.ndarray, seg: int, rng, np_rng) -> np.ndarray:
        if len(noise) >= seg:
            for _ in range(100):
                start = rng.randint(0, len(noise) - seg)
                n = noise[start : start + seg]
                if float((n**2).sum()) > 1e-2:
                    return n
            return n
        nrep = int(np.ceil(seg / len(noise)))
        n = np.tile(noise, nrep)[:seg]
        if float((n**2).sum()) <= 1e-2:
            n = n + 0.1 * np_rng.standard_normal(n.shape)
        return n.astype(np.float32)

    def _mix(self, audio: np.ndarray, seg: int, rng, np_rng) -> tuple[np.ndarray, np.ndarray]:
        noise = load_wav(rng.choice(self.noise_files), self.sampling_rate)
        noise = 100.0 * noise  # pre-amplify (:250)
        noise = self._crop_noise(noise, seg, rng, np_rng)

        snr_db = float(np.round(np_rng.uniform(*self.snr_range), decimals=1))
        l_audio = integrated_loudness(audio, self.sampling_rate)
        l_noise = integrated_loudness(noise, self.sampling_rate)
        gain = 10.0 ** ((l_audio - snr_db - l_noise) / 20.0)
        if not np.isfinite(gain):
            gain = 1.0
        noisy = audio + gain * noise

        # anti-clipping rescale (:304-308)
        while np.max(np.abs(noisy)) >= 1.0:
            target = np_rng.uniform(0.3, 0.9)
            c = target / (np.max(np.abs(noisy)) + 1e-5)
            noisy, audio = noisy * c, audio * c
        return noisy.astype(np.float32), audio.astype(np.float32)

    def get_batch(self, index: int, seed: int | None = None
                  ) -> tuple[np.ndarray, np.ndarray, str]:
        """Build batch `index`. With `seed` the call is self-contained
        (own RNGs) and therefore thread-safe; without it the dataset's
        shared RNGs are used (single-threaded paths, e.g. validation)."""
        if seed is None:
            rng, np_rng = self.rng, self.np_rng
        else:
            rng = random.Random(seed)
            np_rng = np.random.default_rng(seed)
        task = self._draw_task(rng)
        seg = self.segment_size
        inputs, cleans = [], []
        for j in range(self.batch_size):
            idx = (index * self.batch_size + j) % len(self.speech_files)
            audio = load_wav(self.speech_files[idx], self.sampling_rate)
            if self.split:
                audio = self._crop_speech(audio, seg, rng)
            if task == "denoise":
                noisy, clean = self._mix(audio, len(audio), rng, np_rng)
            else:
                noisy, clean = audio, audio
            inputs.append(noisy)
            cleans.append(clean)
        return np.stack(inputs), np.stack(cleans), task

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray, str]]:
        for i in range(len(self)):
            yield self.get_batch(i)


class PrefetchJointLoader:
    """Threaded epoch iterator over a JointDataset.

    The joint batch build is host-heavy (noise decode + two BS.1770
    loudness integrations per item, dataset_joint_denoise_vocoder.py:
    291-301); running it synchronously starves the chip. Worker threads
    build batches by index with per-batch seeded RNGs (deterministic
    given (seed, epoch, index)) into a bounded queue; batches are
    yielded in order.
    """

    def __init__(self, dataset: JointDataset, num_workers: int = 4,
                 seed: int = 1234):
        self.dataset = dataset
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.epoch = 0

    def __len__(self) -> int:
        return len(self.dataset)

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray, str]]:
        import queue
        import threading

        nb = len(self.dataset)
        epoch = self.epoch
        self.epoch += 1
        # per-epoch random batch-visit order: the reference's
        # DataLoader(shuffle=True) over the self-batching Dataset
        # permutes WHICH batch index comes when (composition stays
        # fixed — audio_files shuffled once at init, idx = index*B+j,
        # dataset_joint_denoise_vocoder.py:204-205,242)
        perm = np.random.default_rng(
            self.seed * 7_919 + epoch).permutation(nb).tolist()
        idx_q: queue.Queue = queue.Queue()
        for b in perm:
            idx_q.put(int(b))
        results: dict[int, tuple] = {}
        lock = threading.Lock()
        ready = threading.Condition(lock)
        # backpressure: at most ~2 queue slots per worker in flight
        slots = threading.Semaphore(2 * self.num_workers)

        def worker():
            while True:
                slots.acquire()
                try:
                    b = idx_q.get_nowait()
                except queue.Empty:
                    slots.release()
                    return
                try:
                    # epoch term must out-stride the largest batch index
                    # or augmentation streams repeat across epochs
                    batch = self.dataset.get_batch(
                        b, seed=(self.seed * 1_000_003 + epoch) * 1_000_003 + b)
                except BaseException as e:  # propagate: a dead worker
                    batch = e               # must not hang the consumer
                with ready:
                    results[b] = batch
                    ready.notify_all()

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(min(self.num_workers, max(nb, 1)))]
        for t in threads:
            t.start()
        for b in perm:
            with ready:
                while b not in results:
                    ready.wait()
                batch = results.pop(b)
            slots.release()
            if isinstance(batch, BaseException):
                raise batch
            yield batch
