"""The launch plans of the redesigned kernels, on the CPU.

`dw_plan` (the dW_hh reduction of csrc/lstm_bwd.cu), `fused_wide_plan` (the
wide fused BiLSTM of csrc/lstm_fused_wide.cu), `fused_narrow_plan` (the
narrow fused BiLSTM of csrc/lstm_fused.cu), `scan_narrow_plan` (the narrow
scans of csrc/lstm_scan.cu, and in mode lstm_fwd_hc its residual-saving
forward), `bwd_narrow_plan` (the narrow backward recurrence of
csrc/lstm_bwd.cu), `bwd_wide_plan` (the wide backward recurrence of
csrc/lstm_bwd_wide.cu) and `scan_wide_plan` (csrc/lstm_scan_wide.cu) are
plain functions of the shape, the
dtype and the card's SM count, shared-memory limit and blocks (or clusters)
it holds; the C entries take their plans as arguments. Checked here at an
H100's figures (132 SMs, 232,448 bytes a block) and at a smaller card's (46
SMs, 101,376 bytes): every (row, step) pair in exactly one dW split, every
row in exactly one narrow tile or row group and every unit in one block,
each tile and ring in the shared-memory limit, the grids co-resident or the
plan saying they are not, few rows spread over many clusters, and the plans
the port reports for BSRNN-L's, BSRNN-M's and GCRN's shapes and the H = 8,
16, 64, 120, 128, 136, 448, 512 and 768 edges; lstm_scan_fused's route
at H <= 128 by whether a cluster of the narrow kernel fits (C1); and the
training wrappers' route (`train_route`): the narrow kernels where their plans
run, the wide ones past H = 128 and where nothing fits or no cluster is held.
"""
import pytest
import torch

from nvse_tpu_torch.ops import lstm as L

H100 = (132, 232448)
SMALL = (46, 101376)
BF, F32 = torch.bfloat16, torch.float32
# blocks per SM that an H100 reports for the dW kernels (ops/lstm.py reads them
# from the card): 2 for the bfloat16 one, 1 for the float32 one
DW_BPS = {BF: 2, F32: 1}

# (T, R, H): BSRNN-M / BSRNN-L training (time, band), GCRN, one row and step,
# T * R = 481 at the widest H
DW_SHAPES = [(65, 544, 128), (34, 1040, 128), (65, 544, 256), (34, 1040, 256), (65, 16, 448),
             (1, 1, 8), (13, 37, 768), (1, 300, 136)]


@pytest.mark.parametrize("card", [H100, SMALL], ids=["h100", "small"])
@pytest.mark.parametrize("dtype", [BF, F32])
def test_dw_plan_covers_every_row_once_in_one_wave(card, dtype):
    n_sm, limit = card
    for T, R, H in DW_SHAPES:
        p = L.dw_plan(T, R, H, dtype, n_sm, limit, DW_BPS[dtype])
        N, rows = T * R, p["rows_per_split"]
        splits = [range(s * rows, min(N, (s + 1) * rows)) for s in range(p["nsplit"])]
        assert all(len(s) > 0 for s in splits)
        covered = [n for s in splits for n in s]
        assert covered == list(range(N))                     # each pair once, in order
        assert rows % p["tile_k"] == 0
        assert p["fits"] and p["smem_bytes"] <= limit
        assert p["smem_bytes"] == p["stages"] * p["tile_k"] * 2 * p["pitch"] * (
            2 if dtype == BF else 4)
        # one wave: tiles x splits within the card's resident blocks (a single
        # split may need more only where the tiles alone do)
        assert p["blocks"] == p["tiles"] * p["nsplit"]
        assert p["nsplit"] == 1 or p["blocks"] <= DW_BPS[dtype] * n_sm


def test_dw_plan_at_the_training_shapes_on_an_h100():
    got = {(dt, T, R, H): (p["nsplit"], p["rows_per_split"], p["blocks"])
           for dt in (BF, F32) for T, R, H in DW_SHAPES[:5]
           for p in [L.dw_plan(T, R, H, dt, *H100, DW_BPS[dt])]}
    assert got == {
        (BF, 65, 544, 128): (65, 544, 260), (BF, 34, 1040, 128): (65, 544, 260),
        (BF, 65, 544, 256): (16, 2240, 256), (BF, 34, 1040, 256): (16, 2240, 256),
        (BF, 65, 16, 448): (4, 288, 224),
        (F32, 65, 544, 128): (33, 1072, 132), (F32, 34, 1040, 128): (33, 1072, 132),
        (F32, 65, 544, 256): (8, 4424, 128), (F32, 34, 1040, 256): (8, 4424, 128),
        (F32, 65, 16, 448): (2, 520, 112)}


# (R, T, C, H): BSRNN-L's band, time, chunk (8 streams), chunk (1 stream) and
# context-recompute window; the H = 136, 448 and 512 edges, C + H = 1280
FUSED_SHAPES = [(8192, 34, 256, 256), (272, 1024, 256, 256), (640, 34, 256, 256),
                (80, 34, 256, 256), (96, 34, 256, 256), (130, 2, 136, 136), (40, 3, 448, 448),
                (33, 4, 768, 512), (50, 3, 1024, 256), (150, 5, 8, 512)]


@pytest.mark.parametrize("card", [H100, SMALL], ids=["h100", "small"])
@pytest.mark.parametrize("dtype", [BF, F32])
def test_fused_plan_fits_and_is_co_resident_or_says_not(card, dtype):
    n_sm, limit = card
    for R, T, C, H in FUSED_SHAPES:
        p = L.fused_wide_plan(R, C, H, dtype, n_sm, limit, 1)
        if p["units"] is None:                               # nothing fits this card
            assert not p["co_resident"]
            continue
        assert H % p["units"] == 0 and 2 <= p["stages"] <= L._FUSED_MAX_STAGES
        assert p["kc"] in L._FUSED_KC
        assert p["smem_bytes"] + L._FUSED_STATIC_SMEM <= limit
        assert p["smem_bytes"] == L._fused_smem(p["units"], p["tile_rows"], C, H, dtype,
                                                p["kc"], p["stages"])
        per_group = 2 * H // p["units"]
        if p["co_resident"]:
            assert 1 <= p["groups"] <= R and p["blocks"] == p["groups"] * per_group <= n_sm
            assert p["rows_per_group"] * p["groups"] >= R
            assert p["groups"] <= -(-R // L._MIN_GROUP_ROWS)      # about 8 rows a group or more
        else:
            assert per_group > n_sm and p["groups"] == 0


def test_fused_plan_says_when_no_grid_is_co_resident():
    # 2 x 512 / 32 = 32 blocks a row group on a card of 16 SMs
    p = L.fused_wide_plan(8192, 256, 512, BF, 16, 232448, 1)
    assert p["units"] == 32 and not p["co_resident"] and p["groups"] == 0
    # no blocks an SM (the occupancy query found none): nothing is co-resident
    assert not L.fused_wide_plan(8192, 256, 256, F32, *H100, 0)["co_resident"]


def test_fused_plan_at_bsrnn_l_and_the_edges_on_an_h100():
    keys = ("units", "tile_rows", "kc", "stages", "groups")
    got = {(dt, *s): tuple(p[k] for k in keys)
           for dt in (BF, F32) for s in FUSED_SHAPES
           for p in [L.fused_wide_plan(s[0], *s[2:], dt, *H100, 1)]}
    assert got == {
        (BF, 8192, 34, 256, 256): (32, 64, 256, 2, 8), (BF, 272, 1024, 256, 256): (32, 64, 256, 2, 8),
        (BF, 640, 34, 256, 256): (32, 64, 256, 2, 8), (BF, 80, 34, 256, 256): (16, 64, 256, 4, 4),
        (BF, 96, 34, 256, 256): (16, 64, 256, 4, 4), (BF, 130, 2, 136, 136): (8, 128, 256, 2, 3),
        (BF, 40, 3, 448, 448): (8, 128, 256, 2, 1), (BF, 33, 4, 768, 512): (8, 128, 256, 2, 1),
        (BF, 50, 3, 1024, 256): (8, 128, 256, 2, 2), (BF, 150, 5, 8, 512): (32, 64, 128, 3, 4),
        (F32, 8192, 34, 256, 256): (16, 256, 32, 2, 4), (F32, 272, 1024, 256, 256): (16, 128, 64, 2, 4),
        (F32, 640, 34, 256, 256): (16, 128, 64, 2, 4), (F32, 80, 34, 256, 256): (16, 32, 256, 3, 4),
        (F32, 96, 34, 256, 256): (16, 32, 256, 3, 4), (F32, 130, 2, 136, 136): (8, 128, 128, 2, 3),
        (F32, 40, 3, 448, 448): (8, 128, 64, 3, 1), (F32, 33, 4, 768, 512): (8, 128, 32, 3, 1),
        (F32, 50, 3, 1024, 256): (8, 128, 32, 3, 2), (F32, 150, 5, 8, 512): (16, 128, 64, 2, 2)}


def test_fused_plan_bfloat16_takes_the_next_slice_for_small_groups():
    # 8 groups of 1024, 80 and 34 rows at 32 units; 8 of 10 and 12 take 16 units (4 groups)
    for R, want in ((8192, 32), (640, 32), (272, 32), (80, 16), (96, 16), (34, 16)):
        assert L.fused_wide_plan(R, 256, 256, BF, *H100, 1)["units"] == want


def test_fused_plan_float32_tiles_by_the_rows_of_a_group():
    # groups of 2048, 256, 160, 68, 24 and 9 rows
    for R, want in ((8192, 256), (1024, 128), (640, 128), (272, 128), (96, 32), (34, 32)):
        p = L.fused_wide_plan(R, 256, 256, F32, *H100, 1)
        assert p["tile_rows"] == want and p["units"] == 16


def test_fused_tile_none_where_the_slice_does_not_divide_h_or_fit():
    assert L.fused_wide_tile(256, 136, BF, 232448, 32, 64) is None          # 136 % 32
    assert L.fused_wide_tile(768, 512, F32, 232448, 16, 256) is None        # 328 KB of weights
    t = L.fused_wide_tile(256, 256, BF, 232448, 32, 64)
    assert (t["kc"], t["stages"]) == (256, 2)


# ---------------------------------------------------------------------------
# the narrow fused BiLSTM (csrc/lstm_fused.cu, H <= 128): clusters of K blocks,
# each holding the weight slice of U units
# ---------------------------------------------------------------------------

# (R, C, H): BSRNN-M's decode (time, band), the offline decode beside the streams,
# a streaming chunk of 8 streams and of one, a context-recompute window, serving's
# 128-frame bucket (time, band), the validation crop (time, band); the edges H = 8,
# 16, 120 and 128 with C != H
NARROW_SHAPES = [(272, 128, 128), (8192, 128, 128), (4096, 128, 128), (640, 128, 128),
                 (80, 128, 128), (96, 128, 128), (272, 128, 128), (1024, 128, 128),
                 (34, 128, 128), (129, 128, 128), (3, 12, 8), (7, 16, 16), (203, 124, 120),
                 (300, 64, 32), (50, 256, 128), (1, 4, 8), (100000, 128, 128)]


def _tiles(p, R):
    """The rows of each tile as the kernel cuts them: R * p / ntiles."""
    n = p["ntiles"]
    return [range(R * i // n, R * (i + 1) // n) for i in range(n)]


@pytest.mark.parametrize("card", [H100, SMALL], ids=["h100", "small"])
@pytest.mark.parametrize("dtype", [BF, F32])
def test_narrow_plan_covers_every_row_once_within_shared_memory(card, dtype):
    n_sm, limit = card
    for R, C, H in NARROW_SHAPES:
        p = L.fused_narrow_plan(R, C, H, dtype, n_sm, limit)
        if p["units"] is None:                               # nothing fits this card
            assert not p["co_resident"]
            continue
        assert p["co_resident"]
        U, K = p["units"], p["cluster"]
        assert U in L._NARROW[dtype]["units"] and K == -(-H // U) <= L._NARROW_MAX_CLUSTER
        assert p["inst"] in L._NARROW_INST and p["stages"] in L._NARROW_STAGES
        assert p["smem_bytes"] == L._narrow_smem(U, p["inst"], C, H, dtype, p["stages"])
        assert p["smem_bytes"] + L._NARROW_STATIC_SMEM <= limit
        tiles = _tiles(p, R)
        assert [r for t in tiles for r in t] == list(range(R))   # every row once, in order
        assert all(0 < len(t) <= p["tile_rows"] for t in tiles)
        assert p["tile_rows"] == L._narrow_tile_rows(U, p["inst"], dtype) and p["rows"] == max(map(len, tiles))
        # every cluster of one wave is busy, and the clusters share the tiles evenly
        assert 1 <= p["clusters"] <= min(p["ntiles"], n_sm // K // 2)
        assert p["blocks"] == 2 * p["clusters"] * K <= n_sm
        assert p["rounds"] == -(-p["ntiles"] // p["clusters"])
        assert p["ntiles"] % p["clusters"] == 0 or p["ntiles"] < p["clusters"] * 2


@pytest.mark.parametrize("dtype", [BF, F32])
def test_narrow_plan_holds_bsrnn_m_time_shape_in_one_wave(dtype):
    """272 rows of both directions at once: a tile for every cluster, every
    tile resident, against 68 blocks of 8 rows before."""
    for clusters in (None, 66 if dtype == BF else 30):       # by SM count; as an H100 reports
        p = L.fused_narrow_plan(272, 128, 128, dtype, *H100, clusters)
        assert p["rounds"] == 1 and p["ntiles"] == p["clusters"]
        assert p["blocks"] >= 120 and p["rows"] * p["ntiles"] >= 272


def test_narrow_plan_at_bsrnn_m_shapes_on_an_h100():
    keys = ("units", "cluster", "inst", "rows", "ntiles", "clusters", "stages")
    got = {(dt, R): tuple(p[k] for k in keys)
           for dt, n in ((BF, 66), (F32, 30)) for R in (272, 8192, 4096, 640, 80, 96, 1024, 34, 129)
           for p in [L.fused_narrow_plan(R, 128, 128, dt, *H100, n)]}
    assert got == {
        (BF, 272): (64, 2, 1, 9, 33, 33, 3), (BF, 8192): (64, 2, 4, 63, 132, 33, 3),
        (BF, 4096): (64, 2, 4, 63, 66, 33, 3), (BF, 640): (64, 2, 2, 20, 33, 33, 3),
        (BF, 80): (64, 2, 1, 3, 33, 33, 3), (BF, 96): (64, 2, 1, 3, 33, 33, 3),
        (BF, 1024): (64, 2, 2, 32, 33, 33, 3), (BF, 34): (64, 2, 1, 2, 33, 33, 3),
        (BF, 129): (64, 2, 1, 4, 33, 33, 3),
        (F32, 272): (32, 4, 4, 19, 15, 15, 3), (F32, 8192): (32, 4, 4, 31, 270, 15, 3),
        (F32, 4096): (32, 4, 4, 31, 135, 15, 3), (F32, 640): (32, 4, 4, 22, 30, 15, 3),
        (F32, 80): (32, 4, 1, 6, 15, 15, 3), (F32, 96): (32, 4, 1, 7, 15, 15, 3),
        (F32, 1024): (32, 4, 4, 23, 45, 15, 3),
        (F32, 34): (32, 4, 1, 3, 15, 15, 3), (F32, 129): (32, 4, 2, 9, 15, 15, 3)}
    # tensor cores in bfloat16, CUDA-core FMAs in float32
    assert L.fused_narrow_plan(272, 128, 128, BF, *H100)["tensor_cores"]
    assert not L.fused_narrow_plan(272, 128, 128, F32, *H100)["tensor_cores"]


def test_narrow_plan_at_the_edges_of_h():
    # H = 8 and 16: one block a cluster; H = 120: two blocks of 64 units in bfloat16 (8
    # past H), four of 32 in float32; C != H, C % 8 == 4 (bfloat16 rows of x not 16-byte aligned)
    for H, C, dt, U, K in ((8, 12, BF, 8, 1), (8, 12, F32, 8, 1), (16, 16, BF, 16, 1),
                           (16, 16, F32, 16, 1), (120, 124, BF, 64, 2), (120, 124, F32, 32, 4),
                           (128, 256, BF, 64, 2), (128, 256, F32, 32, 4), (24, 24, BF, 32, 1)):
        p = L.fused_narrow_plan(203, C, H, dt, *H100)
        assert (p["units"], p["cluster"]) == (U, K) and p["co_resident"]
    # C + H past what a cluster of 8 holds: nothing fits, and the wrapper raises
    assert not L.fused_narrow_plan(272, 1400, 128, BF, *H100)["co_resident"]
    assert L.fused_narrow_plan(272, 1400, 128, BF, *H100)["units"] is None
    # a card that holds no cluster
    assert not L.fused_narrow_plan(272, 128, 128, BF, *H100, 1)["co_resident"]


@pytest.mark.parametrize("dtype", [F32, BF])
def test_narrow_plan_persistent_or_waves(dtype):
    """Where the card's clusters hold every row, each cluster takes one tile
    (one wave); past that the clusters of a direction are all co-resident and
    walk a whole number of tiles each (persistent), never a second wave."""
    for R in (80, 272, 640, 4096, 8192):
        plan = L.fused_narrow_plan(R, 128, 128, dtype, *H100)
        per_dir = 132 // plan["cluster"] // 2
        assert plan["clusters"] == min(per_dir, plan["ntiles"])
        assert plan["ntiles"] == plan["clusters"] * plan["rounds"]
        assert plan["blocks"] <= 132
        if plan["rounds"] > 1:
            assert plan["clusters"] == per_dir
            assert plan["rows"] > plan["tile_rows"] // 2


def test_narrow_smem_matches_the_kernels_layout():
    # bfloat16, 64 units, 16-row tiles, C = H = 128, 3 stages: the [256][264] slice,
    # b, two h buffers of 16 x 136, three x stages of 16 x 136
    assert L._narrow_smem(64, 1, 128, 128, BF, 3) == 256 * 264 * 2 + 256 * 4 + (2 + 3) * 16 * 136 * 2
    # float32, 32 units, 32-row tiles: the [256][128] slice, b, h and x rows padded by 4
    assert L._narrow_smem(32, 4, 128, 128, F32, 3) == 256 * 128 * 4 + 128 * 4 + (2 + 3) * 32 * 132 * 4


# ---------------------------------------------------------------------------
# C1: lstm_scan_fused's route at H <= 128 where no cluster of the narrow kernel fits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [BF, F32])
def test_fused_route_by_the_narrow_kernels_fit(dtype):
    # C + H past what a cluster of 8 holds: the projection and lstm_scan_bidir2
    assert L.fused_route(1400, 128, dtype, *H100) == "projection+lstm_bidir2"
    assert L.fused_route(128, 128, dtype, *H100) == "lstm_fused"
    assert L.fused_route(256, 256, dtype, *H100) == "lstm_fused_wide"
    assert L._fused_route(1400, 128, narrow_fits=False) == "projection+lstm_bidir2"


# ---------------------------------------------------------------------------
# the narrow scan (csrc/lstm_scan.cu): scan_narrow_plan
# ---------------------------------------------------------------------------

# (R, H, directions): BSRNN-M's decode, window, chunk and chunk1; B7's time and band
# (rows of one direction); ragged and one-row cases; the H = 8 / 64 / 120 edges;
# more rows than one wave holds
SCAN_SHAPES = [(272, 128, 1), (34, 128, 1), (3, 128, 1), (1, 8, 1), (203, 120, 1), (700, 64, 1),
               (544, 128, 2), (8192, 128, 2), (20, 128, 2), (37, 8, 2), (100000, 128, 1)]


@pytest.mark.parametrize("card", [H100, SMALL], ids=["h100", "small"])
@pytest.mark.parametrize("dtype", [BF, F32])
def test_scan_plan_covers_every_row_and_unit_once_within_shared_memory(card, dtype):
    n_sm, limit = card
    for R, H, dirs in SCAN_SHAPES:
        p = L.scan_narrow_plan(R, H, dtype, n_sm, limit, directions=dirs)
        assert p["co_resident"]
        U, K = p["units"], p["cluster"]
        assert U == L._SCAN[dtype]["units"] and K == -(-H // U) <= 8
        # every unit of H in one block of the cluster
        assert [u for b in range(K) for u in range(b * U, min(H, b * U + U))] == list(range(H))
        assert p["inst"] in L._SCAN[dtype]["insts"] and p["stages"] == L._SCAN_STAGES
        assert p["smem_bytes"] == L._scan_smem(p["inst"], dtype, p["stages"])
        assert p["smem_bytes"] + L._SCAN_STATIC_SMEM <= limit
        tiles = _tiles(p, R)
        assert [r for t in tiles for r in t] == list(range(R))   # every row once, in order
        assert all(0 < len(t) <= p["tile_rows"] for t in tiles)
        assert p["rows"] == max(map(len, tiles))
        assert 1 <= p["clusters"] <= min(p["ntiles"], n_sm // K // dirs)
        assert p["blocks"] == dirs * p["clusters"] * K <= n_sm
        assert p["rounds"] == -(-p["ntiles"] // p["clusters"])
        # one wave where the card's clusters hold every row; else every cluster busy
        if R <= (n_sm // K // dirs) * p["tile_rows"] and p["inst"] < max(L._SCAN[dtype]["insts"]):
            assert p["rounds"] == 1
        if p["rounds"] > 1:
            assert p["clusters"] == n_sm // K // dirs and p["ntiles"] % p["clusters"] == 0


@pytest.mark.parametrize("dtype", [BF, F32])
def test_scan_plan_spreads_few_rows_and_holds_the_decode_in_one_wave(dtype):
    # 34 rows (one stream's chunk or window): a tile for each of more than one cluster,
    # at most two rows a tile; 272 (8 streams, the decode): one wave, every SM
    p = L.scan_narrow_plan(34, 128, dtype, *H100)
    assert p["clusters"] > 1 and p["rows"] <= 2 and p["rounds"] == 1
    p = L.scan_narrow_plan(272, 128, dtype, *H100)
    assert p["rounds"] == 1 and p["blocks"] == 132
    assert p["tensor_cores"] == (dtype == BF)


def test_scan_plan_at_bsrnn_m_shapes_on_an_h100():
    keys = ("units", "cluster", "inst", "rows", "ntiles", "clusters", "rounds")
    got = {(dt, R, d): tuple(p[k] for k in keys)
           for dt in (BF, F32) for R, d in ((272, 1), (34, 1), (544, 2), (8192, 2))
           for p in [L.scan_narrow_plan(R, 128, dt, *H100, directions=d)]}
    assert got == {
        (BF, 272, 1): (64, 2, 1, 5, 66, 66, 1), (BF, 34, 1): (64, 2, 1, 1, 34, 34, 1),
        (BF, 544, 2): (64, 2, 2, 17, 33, 33, 1), (BF, 8192, 2): (64, 2, 4, 63, 132, 33, 4),
        (F32, 272, 1): (32, 4, 16, 9, 33, 33, 1), (F32, 34, 1): (32, 4, 2, 2, 33, 33, 1),
        (F32, 544, 2): (32, 4, 16, 12, 48, 16, 3), (F32, 8192, 2): (32, 4, 16, 16, 512, 16, 32)}


def test_scan_plan_says_when_it_cannot_run():
    assert not L.scan_narrow_plan(34, 136, BF, *H100)["co_resident"]     # past H = 128
    assert not L.scan_narrow_plan(34, 128, BF, *H100, 0)["co_resident"]  # no cluster held
    assert not L.scan_narrow_plan(34, 128, F32, 3, 232448)["co_resident"]


def test_scan_smem_matches_the_kernels_layout():
    # bfloat16, 16-row tiles: two h buffers of 16 x 136, three x stages of 16 x 4 x 64,
    # and the 16 warps' float32 gate scratch of 16 x 24
    assert L._scan_smem(1, BF, 3) == (2 * 16 * 136 + 3 * 16 * 256) * 2 + 16 * 16 * 24 * 4
    # float32, 16 rows a thread: two h buffers of 16 x 128, three stages of 16 x 4 x 32
    assert L._scan_smem(16, F32, 3) == (2 * 16 * 128 + 3 * 16 * 128) * 4


# ---------------------------------------------------------------------------
# the wide backward recurrence (csrc/lstm_bwd_wide.cu): bwd_wide_plan
# ---------------------------------------------------------------------------

# (R, H): BSRNN-L training (time, band), GCRN, one row, ragged rows, the edges
BWD_SHAPES = [(544, 256), (1040, 256), (16, 448), (1, 136), (19, 768), (300, 768), (130, 136),
              (5000, 256)]


def _groups(p, R):
    """The rows of each row group as the kernel cuts them: R * g / groups."""
    n = p["groups"]
    return [range(R * g // n, R * (g + 1) // n) for g in range(n)]


@pytest.mark.parametrize("card", [H100, SMALL], ids=["h100", "small"])
@pytest.mark.parametrize("dtype", [BF, F32])
def test_bwd_wide_plan_covers_every_row_and_unit_once_within_shared_memory(card, dtype):
    n_sm, limit = card
    for R, H in BWD_SHAPES:
        p = L.bwd_wide_plan(R, H, dtype, n_sm, limit)
        if not p["co_resident"]:         # the widest slices need more than the small card's
            assert card == SMALL and H >= 448 and p["units"] is None
            continue
        U, TM = p["units"], p["tile_rows"]
        assert (U, TM) in L._BWD_WIDE[dtype] and H % U == 0
        groups = _groups(p, R)
        assert [r for g in groups for r in g] == list(range(R))   # every row once
        assert max(map(len, groups)) == p["rows_per_group"]
        assert p["tiles_per_group"] == -(-p["rows_per_group"] // TM)
        # the group's H / U blocks hold every unit once; one wave of co-resident blocks
        assert p["blocks"] == p["groups"] * (H // U) <= n_sm
        assert p["smem_bytes"] == L._bwd_wide_smem(U, TM, H, dtype)
        assert p["smem_bytes"] <= limit
        # as many groups as the card holds, at most one a row
        assert p["groups"] == min(n_sm // (H // U), R)


def test_bwd_wide_plan_at_bsrnn_l_and_gcrn_on_an_h100():
    keys = ("units", "tile_rows", "groups", "rows_per_group", "tiles_per_group", "blocks")
    got = {(dt, R, H): tuple(p[k] for k in keys)
           for dt in (BF, F32) for R, H in ((544, 256), (1040, 256), (16, 448))
           for p in [L.bwd_wide_plan(R, H, dt, *H100)]}
    assert got == {
        (BF, 544, 256): (32, 64, 16, 34, 1, 128), (BF, 1040, 256): (32, 64, 16, 65, 2, 128),
        (BF, 16, 448): (16, 32, 4, 4, 1, 112),
        (F32, 544, 256): (16, 64, 8, 68, 2, 128), (F32, 1040, 256): (16, 64, 8, 130, 3, 128),
        (F32, 16, 448): (8, 32, 2, 8, 1, 112)}
    # GCRN's 16 rows: the widest slice leaves groups of 2 (bfloat16) or 4 (float32) rows,
    # so the next slice is taken; with the blocks an H100 reports for each instance, the
    # float32 time shape takes 32-row tiles at 2 blocks an SM: 16 groups of 34 rows
    bps = {(16, 64): 1, (16, 32): 2, (8, 64): 2, (8, 32): 2}
    p = L.bwd_wide_plan(544, 256, F32, *H100, bps)
    assert (p["units"], p["tile_rows"], p["groups"], p["blocks"]) == (16, 32, 16, 256)
    assert L.bwd_wide_plan(544, 256, BF, *H100)["tensor_cores"]
    assert not L.bwd_wide_plan(544, 256, F32, *H100)["tensor_cores"]


def test_bwd_wide_plan_says_when_nothing_fits():
    assert not L.bwd_wide_plan(16, 768, F32, 132, 101376)["co_resident"]   # the slice alone
    assert not L.bwd_wide_plan(16, 776, BF, *H100)["co_resident"]          # past H = 768
    assert not L.bwd_wide_plan(16, 256, BF, 4, 232448)["co_resident"]      # no group fits


def test_bwd_wide_smem_matches_the_kernels_layout():
    # bfloat16, U = 32, 64-row tiles, H = 256: the [128][264] slice, the [64][264] h
    # tile, float32 [64][128] gates, hi and lo [64][136]
    assert L._bwd_wide_smem(32, 64, 256, BF) == (128 * 264 * 2 + 64 * 264 * 2 + 64 * 128 * 4
                                                 + 2 * 64 * 136 * 2)
    # float32, U = 16: the [256][65] slice, the [64][260] h tile, [64][68] gates
    assert L._bwd_wide_smem(16, 64, 256, F32) == 256 * 65 * 4 + 64 * 260 * 4 + 64 * 68 * 4


# ---------------------------------------------------------------------------
# the wide forward scans (csrc/lstm_scan_wide.cu): scan_wide_plan
# ---------------------------------------------------------------------------

# (wrapper, directions): the kernel's four modes
SCAN_WIDE_MODES = [("lstm_scan", 1), ("lstm_scan_stateful", 1), ("lstm_fwd_hc", 1),
                   ("lstm_scan_bidir", 2)]
# (R, H): BSRNN-L's paths (training, decode, chunks, windows), GCRN's training
# forward, B7's band rows, one row, ragged rows, the edges
SCAN_WIDE_SHAPES = [(544, 256), (1040, 256), (272, 256), (34, 256), (16, 448), (8192, 256),
                    (1, 136), (19, 768), (300, 768), (130, 264), (37, 760)]


def _random_cards(n, seed=0):
    """(n_sm, smem limit, blocks an SM of each instance) of n made-up cards."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [(int(rng.integers(8, 200)), int(rng.integers(96, 228)) * 1024,
             {dt: {i: int(rng.integers(0, 4)) for i in L._SCAN_WIDE[dt]} for dt in (BF, F32)})
            for _ in range(n)]


@pytest.mark.parametrize("mode,dirs", SCAN_WIDE_MODES, ids=[m for m, _ in SCAN_WIDE_MODES])
@pytest.mark.parametrize("dtype", [BF, F32])
def test_scan_wide_plan_covers_every_row_and_unit_once_within_shared_memory(mode, dirs, dtype):
    for n_sm, limit, bps in [(*H100, None), (*SMALL, None), *_random_cards(12)]:
        bps = 1 if bps is None else bps[dtype]
        for R, H in SCAN_WIDE_SHAPES:
            p = L.scan_wide_plan(R, H, dtype, n_sm, limit, bps, dirs, mode)
            if not p["co_resident"]:         # no instance fits this card: checked below
                continue
            U, TM = p["units"], p["tile_rows"]
            assert (U, TM) in L._SCAN_WIDE[dtype] and H % U == 0
            groups = _groups(p, R)
            assert [r for g in groups for r in g] == list(range(R))   # every row once
            assert max(map(len, groups)) == p["rows_per_group"]
            assert p["tiles_per_group"] == -(-p["rows_per_group"] // TM)
            assert p["smem_bytes"] == L._scan_wide_smem(U, TM, H, dtype, mode) <= limit
            # the group's H / U blocks hold every unit once; one wave of co-resident blocks
            per_sm = bps if isinstance(bps, int) else bps[(U, TM)]
            slots = per_sm * n_sm // (H // U)
            d = p["launch_dirs"]
            assert d == (dirs if slots >= dirs else 1)
            # co-resident; one block an SM (one group where a group alone needs more);
            # at least 8 rows a group where R has them (4 for the training forward
            # in bfloat16)
            least = 4 if dtype == BF and mode == "lstm_fwd_hc" else 8
            assert p["groups"] == min(slots // d, max(1, n_sm // (d * H // U)), max(1, R // least))
            assert p["blocks"] == d * p["groups"] * (H // U) <= per_sm * n_sm
            assert p["blocks"] <= n_sm or p["groups"] == 1
            assert p["tensor_cores"] == (dtype == BF)


def test_scan_wide_plan_at_bsrnn_l_gcrn_and_b7_on_an_h100():
    keys = ("units", "tile_rows", "groups", "rows_per_group", "tiles_per_group", "launch_dirs",
            "blocks")
    cases = [("lstm_fwd_hc", 544, 65), ("lstm_fwd_hc", 1040, 34), ("lstm_fwd_hc", 16, 65),
             ("lstm_scan", 272, 1024), ("lstm_scan_stateful", 272, 80), ("lstm_scan", 34, 96),
             ("lstm_scan_stateful", 34, 80), ("lstm_scan_bidir", 544, 1024),
             ("lstm_scan_bidir", 8192, 68)]
    got = {(dt, mode, R, T): tuple(p[k] for k in keys)
           for dt in (BF, F32) for mode, R, T in cases
           for p in [L.scan_wide_plan(R, 448 if R == 16 else 256, dt, *H100, 1,
                                      2 if mode == "lstm_scan_bidir" else 1, mode)]}
    assert got == {
        # BSRNN-L's training forward: the time and band BiLSTMs, one block an SM
        (BF, "lstm_fwd_hc", 544, 65): (32, 64, 16, 34, 1, 1, 128),
        (BF, "lstm_fwd_hc", 1040, 34): (32, 64, 16, 65, 2, 1, 128),
        (F32, "lstm_fwd_hc", 544, 65): (16, 64, 8, 68, 2, 1, 128),
        (F32, "lstm_fwd_hc", 1040, 34): (16, 64, 8, 130, 3, 1, 128),
        # GCRN's 16 rows at H = 448: groups of 4 (bfloat16) or 8 (float32) rows, the
        # widest slice that then fills the card
        (BF, "lstm_fwd_hc", 16, 65): (16, 32, 4, 4, 1, 1, 112),
        (F32, "lstm_fwd_hc", 16, 65): (8, 32, 2, 8, 1, 1, 112),
        # the causal decode (and the offline decode beside the streams), a chunk of 8 streams
        (BF, "lstm_scan", 272, 1024): (32, 32, 16, 17, 1, 1, 128),
        (BF, "lstm_scan_stateful", 272, 80): (32, 32, 16, 17, 1, 1, 128),
        (F32, "lstm_scan", 272, 1024): (16, 64, 8, 34, 1, 1, 128),
        (F32, "lstm_scan_stateful", 272, 80): (16, 64, 8, 34, 1, 1, 128),
        # a window and a chunk of one stream: 34 rows, 4 groups of 8-9
        (BF, "lstm_scan", 34, 96): (8, 32, 4, 9, 1, 1, 128),
        (BF, "lstm_scan_stateful", 34, 80): (8, 32, 4, 9, 1, 1, 128),
        (F32, "lstm_scan", 34, 96): (8, 32, 4, 9, 1, 1, 128),
        (F32, "lstm_scan_stateful", 34, 80): (8, 32, 4, 9, 1, 1, 128),
        # B7: both directions in one launch
        (BF, "lstm_scan_bidir", 544, 1024): (32, 64, 8, 68, 2, 2, 128),
        (BF, "lstm_scan_bidir", 8192, 68): (32, 64, 8, 1024, 16, 2, 128),
        (F32, "lstm_scan_bidir", 544, 1024): (16, 64, 4, 136, 3, 2, 128),
        (F32, "lstm_scan_bidir", 8192, 68): (16, 64, 4, 2048, 32, 2, 128)}
    # a second block an SM buys nothing where one block an SM fills the card ...
    p = L.scan_wide_plan(272, 256, BF, *H100, 2)
    assert (p["units"], p["groups"], p["blocks"]) == (32, 16, 128)
    # ... but makes a group co-resident where it needs more blocks than the card has
    # SMs: at H = 768 in float32 a group is 96 blocks of 8 units
    assert L.scan_wide_plan(16, 768, F32, 46, 232448, 2)["co_resident"] is False
    p = L.scan_wide_plan(16, 768, F32, 46, 232448, 3)
    assert (p["units"], p["groups"], p["blocks"]) == (8, 1, 96)


@pytest.mark.parametrize("mode,dirs", SCAN_WIDE_MODES, ids=[m for m, _ in SCAN_WIDE_MODES])
@pytest.mark.parametrize("dtype", [BF, F32])
def test_scan_wide_plan_fits_at_every_h_on_an_h100(mode, dirs, dtype):
    """Where the JAX function computes, the port computes: every H of the wide
    kernel, few rows and many, one block an SM."""
    for H in range(136, 769, 8):
        for R in (1, 16, 34, 1040):
            p = L.scan_wide_plan(R, H, dtype, *H100, 1, dirs, mode)
            assert p["co_resident"], (H, R, p)
    # both directions of B7 in one launch up to H = 768 in bfloat16; float32 at H = 768
    # takes one launch a direction (2 x 96 blocks of 8 units on 132 SMs)
    assert L.scan_wide_plan(5, 768, BF, *H100, 1, 2, "lstm_scan_bidir")["launch_dirs"] == 2
    assert L.scan_wide_plan(5, 768, F32, *H100, 1, 2, "lstm_scan_bidir")["launch_dirs"] == 1


def test_scan_wide_plan_says_when_nothing_fits():
    assert not L.scan_wide_plan(16, 776, BF, *H100)["co_resident"]          # past H = 768
    assert not L.scan_wide_plan(16, 256, F32, 4, 232448)["co_resident"]     # no group fits
    assert not L.scan_wide_plan(16, 768, F32, 132, 101376)["co_resident"]   # the slice alone
    assert not L.scan_wide_plan(16, 256, BF, *H100, 0)["co_resident"]       # no block an SM
    assert not L.scan_wide_plan(0, 256, BF, *H100)["co_resident"]           # no row
    # the split h of the training forward needs more than the scan: at H = 760 in
    # bfloat16 (8-unit slices only) a 120 KB card holds the scan but not lstm_fwd_hc
    assert L.scan_wide_plan(16, 760, BF, 132, 122880)["co_resident"]
    assert not L.scan_wide_plan(16, 760, BF, 132, 122880, mode="lstm_fwd_hc")["co_resident"]


def test_scan_wide_smem_matches_the_kernels_layout():
    # bfloat16, U = 32, 64-row tiles, H = 256: the [128][264] slice, the [64][264] h
    # tile (two planes, hi and lo, for lstm_fwd_hc), float32 [64][136] gates, the
    # x ring [2][64][128]
    scan = 128 * 264 * 2 + 64 * 264 * 2 + 64 * 136 * 4 + 2 * 64 * 128 * 2
    assert L._scan_wide_smem(32, 64, 256, BF) == scan
    assert L._scan_wide_smem(32, 64, 256, BF, "lstm_fwd_hc") == scan + 64 * 264 * 2
    # float32, U = 16: the [256][65] slice, the [64][260] h tile, [64][68] gates, the
    # x ring [2][64][64]; one plane in every mode
    f32 = 256 * 65 * 4 + 64 * 260 * 4 + 64 * 68 * 4 + 2 * 64 * 64 * 4
    assert L._scan_wide_smem(16, 64, 256, F32) == f32
    assert L._scan_wide_smem(16, 64, 256, F32, "lstm_fwd_hc") == f32
    # H = 136 in bfloat16 pads k to 144, then 8: rows of 152
    assert L._scan_wide_smem(8, 32, 136, BF) == (32 * 152 * 2 + 32 * 152 * 2 + 32 * 40 * 4
                                                 + 2 * 32 * 32 * 2)


# ---------------------------------------------------------------------------
# the narrow training kernels: scan_narrow_plan in mode lstm_fwd_hc (csrc/lstm_scan.cu
# mode kFwdHc), bwd_narrow_plan (csrc/lstm_bwd.cu) and the route between them and the
# wide kernels (train_route)
# ---------------------------------------------------------------------------

# (R, H): BSRNN-M's training shapes (time, band), a few rows, one row, ragged rows,
# the H = 8 / 64 / 120 edges, more rows than one wave holds
TRAIN_SHAPES = [(544, 128), (1040, 128), (16, 128), (1, 8), (37, 120), (203, 64), (2000, 128),
                (100000, 128)]
# cards: an H100's and a smaller card's figures, and made-up ones; clusters the card
# holds: one block an SM (None), and fewer
TRAIN_CARDS = [H100, SMALL, (80, 232448), (17, 200000), (132, 120000)]


def _train_plan_coverage(p, R, H, n_sm, clusters, units, insts):
    """Every row in one tile and every unit of H in one block of the cluster;
    the clusters one wave of the card, sharing the tiles evenly."""
    U, K = p["units"], p["cluster"]
    assert U == units and K == -(-H // U) <= 8
    assert [u for b in range(K) for u in range(b * U, min(H, b * U + U))] == list(range(H))
    tiles = _tiles(p, R)
    assert [r for t in tiles for r in t] == list(range(R))      # every row once, in order
    assert all(0 < len(t) <= p["tile_rows"] for t in tiles) and p["rows"] == max(map(len, tiles))
    held = n_sm // K if clusters is None else clusters
    assert 1 <= p["clusters"] <= min(p["ntiles"], held)
    assert p["blocks"] == p["clusters"] * K <= n_sm
    assert p["rounds"] == -(-p["ntiles"] // p["clusters"])
    if p["rounds"] > 1:                        # past one wave: every cluster busy, even shares
        assert p["clusters"] == held and p["ntiles"] % p["clusters"] == 0
    if R <= held * max(insts):                 # one wave where the clusters hold every row
        assert p["rounds"] == 1


@pytest.mark.parametrize("card", TRAIN_CARDS, ids=lambda c: f"{c[0]}sm_{c[1]}")
@pytest.mark.parametrize("dtype", [BF, F32])
def test_fwd_hc_plan_covers_every_row_and_unit_once_within_shared_memory(card, dtype):
    n_sm, limit = card
    insts = L._scan_insts(dtype, "lstm_fwd_hc")
    for R, H in TRAIN_SHAPES:
        for clusters in (None, 3):
            p = L.scan_narrow_plan(R, H, dtype, n_sm, limit, clusters, mode="lstm_fwd_hc")
            assert p["co_resident"] and L.train_route("lstm_fwd_hc", H, p) == "lstm_scan"
            assert p["inst"] in insts and p["stages"] == L._SCAN_STAGES
            assert p["tile_rows"] == L._SCAN[dtype]["rows"] * p["inst"]
            assert p["smem_bytes"] == L._scan_smem(p["inst"], dtype, p["stages"], "lstm_fwd_hc")
            assert p["smem_bytes"] + L._SCAN_STATIC_SMEM <= limit
            fit = [i for i in insts if L._scan_smem(i, dtype, L._SCAN_STAGES, "lstm_fwd_hc")
                   + L._SCAN_STATIC_SMEM <= limit]
            _train_plan_coverage(p, R, H, n_sm, clusters, L._SCAN[dtype]["units"],
                                 [L._SCAN[dtype]["rows"] * i for i in fit])


@pytest.mark.parametrize("card", TRAIN_CARDS, ids=lambda c: f"{c[0]}sm_{c[1]}")
@pytest.mark.parametrize("dtype", [BF, F32])
def test_bwd_narrow_plan_covers_every_row_and_unit_once_within_shared_memory(card, dtype):
    n_sm, limit = card
    d = L._BWD_NARROW[dtype]
    fit = [b for b in d["tiles"] if L._bwd_narrow_smem(b, dtype, min(L._BWD_NARROW_STAGES))
           + L._BWD_NARROW_STATIC_SMEM <= limit]
    for R, H in TRAIN_SHAPES:
        for clusters in (None, 3):
            p = L.bwd_narrow_plan(R, H, dtype, n_sm, limit, clusters)
            if not fit:                        # bfloat16's slice and ring need ~158 KB
                assert dtype == BF and limit < 160000 and not p["co_resident"]
                assert L.train_route("lstm_bwd", H, p) == "lstm_bwd_wide"
                continue
            assert p["co_resident"] and L.train_route("lstm_bwd", H, p) == "lstm_bwd"
            assert p["tile_rows"] in d["tiles"] and p["stages"] in L._BWD_NARROW_STAGES
            assert p["smem_bytes"] == L._bwd_narrow_smem(p["tile_rows"], dtype, p["stages"])
            assert p["smem_bytes"] + L._BWD_NARROW_STATIC_SMEM <= limit
            # the ring as deep as fits
            deeper = [s for s in L._BWD_NARROW_STAGES if s > p["stages"]]
            assert all(L._bwd_narrow_smem(p["tile_rows"], dtype, s) + L._BWD_NARROW_STATIC_SMEM
                       > limit for s in deeper)
            _train_plan_coverage(p, R, H, n_sm, clusters, d["units"], fit)
            assert p["tensor_cores"] == (dtype == BF)


def test_train_narrow_plans_at_bsrnn_m_training_shapes_on_an_h100():
    """With the clusters an H100 holds (66 of 2 blocks in bfloat16, 30 of 4 in
    float32): one tile a cluster, one wave, at both shapes; float32 takes
    tiles of 32 and 48 rows (the forward in passes of 16)."""
    fkeys = ("units", "cluster", "inst", "rows", "ntiles", "clusters", "rounds")
    bkeys = ("units", "cluster", "tile_rows", "rows", "ntiles", "clusters", "rounds", "stages")
    got = {(dt, R): (tuple(L.scan_narrow_plan(R, 128, dt, *H100, n, mode="lstm_fwd_hc")[k]
                           for k in fkeys),
                     tuple(L.bwd_narrow_plan(R, 128, dt, *H100, n)[k] for k in bkeys))
           for dt, n in ((BF, 66), (F32, 30)) for R in (544, 1040)}
    assert got == {
        (BF, 544): ((64, 2, 1, 9, 66, 66, 1), (64, 2, 16, 9, 66, 66, 1, 3)),
        (BF, 1040): ((64, 2, 1, 16, 66, 66, 1), (64, 2, 16, 16, 66, 66, 1, 3)),
        (F32, 544): ((32, 4, 32, 19, 30, 30, 1), (32, 4, 32, 19, 30, 30, 1, 3)),
        (F32, 1040): ((32, 4, 48, 35, 30, 30, 1), (32, 4, 48, 35, 30, 30, 1, 2))}
    # the inference modes keep their float32 instances (up to 16 rows a thread)
    assert L.scan_narrow_plan(1040, 128, F32, *H100, 30)["inst"] == 16


@pytest.mark.parametrize("name", ["lstm_fwd_hc", "lstm_bwd"])
@pytest.mark.parametrize("dtype", [BF, F32])
def test_train_narrow_plans_say_when_they_cannot_run_and_take_the_wide_route(name, dtype):
    plan = (lambda R, H, *card, clusters=None: L.scan_narrow_plan(
                R, H, dtype, *card, clusters, mode="lstm_fwd_hc")) if name == "lstm_fwd_hc" \
        else (lambda R, H, *card, clusters=None: L.bwd_narrow_plan(R, H, dtype, *card, clusters))
    narrow, wide = L._TRAIN_KERNELS[name]
    assert L.train_route(name, 128, plan(544, 128, *H100)) == narrow
    for p in (plan(544, 136, *H100),                 # past H = 128
              plan(544, 128, *H100, clusters=0),     # no cluster held
              plan(544, 128, 132, 2000),             # no tile fits the shared memory
              plan(0, 128, *H100)):                  # no row
        assert not p["co_resident"] and L.train_route(name, 128, p) == wide
    # past H = 128 the wide kernel, whatever a plan says
    assert L.train_route(name, 136, dict(co_resident=True)) == wide


def test_fwd_hc_and_bwd_narrow_smem_match_the_kernels_layout():
    # the forward, bfloat16, 16-row tiles: two h and two lo buffers of 16 x 136, three x
    # stages of 16 x 4 x 64, the warps' gate scratch; float32, 48 rows (no lo planes)
    assert L._scan_smem(1, BF, 3, "lstm_fwd_hc") == ((4 * 16 * 136 + 3 * 16 * 256) * 2
                                                     + 16 * 16 * 24 * 4)
    assert L._scan_smem(48, F32, 3, "lstm_fwd_hc") == (2 * 48 * 128 + 3 * 48 * 128) * 4
    # the backward, bfloat16, 16 rows, 3 stages: the [256][136] slice, stages of h (136),
    # x (256) and dhs, c_t, c_{t-1} (64 each), gate sums [16][260] float32, dgates hi
    # and lo [16][264], shares [2][2][16][68] float32
    assert L._bwd_narrow_smem(16, BF, 3) == (256 * 136 * 2 + 3 * 16 * (136 + 448) * 2
                                             + 16 * 260 * 4 + 2 * 16 * 264 * 2
                                             + 2 * 2 * 16 * 68 * 4)
    # float32, 48 rows, 2 stages: no slice (registers), stages of h (132), x (128) and
    # three planes of 32, gate sums [48][132], shares [2][4][48][36]
    assert L._bwd_narrow_smem(48, F32, 2) == (2 * 48 * (132 + 224) * 4 + 48 * 132 * 4
                                              + 2 * 4 * 48 * 36 * 4)


# ---------------------------------------------------------------------------
# lstm_scan_bidir2's routes (`bidir2_plan`) and the TCN tail's tiles (`tail_plan`)
# ---------------------------------------------------------------------------

# (T, R, H): GCRN's decode and serving shapes, its training rows, more rows than
# one cluster's tile, HD-Demucs's H = 768 (decode and ragged), the H <= 128 routes
# (B7's small shape, C1), one row, the 136 / 256 / 512 edges
BIDIR2_SHAPES = [(1024, 8, 448), (128, 8, 448), (65, 16, 448), (65, 33, 448), (1024, 8, 768),
                 (9, 5, 768), (65, 16, 128), (3, 4, 128), (9, 3, 64), (2, 1, 8), (1, 1, 448),
                 (17, 7, 136), (5, 200, 256), (5, 64, 512)]


def _bidir2_units(p, H):
    """Every unit of H in exactly one block of a cluster of p's."""
    U, K = p["units"], p["cluster"]
    return [u for b in range(K) for u in range(b * U, min(H, b * U + U))] == list(range(H))


@pytest.mark.parametrize("card", [H100, SMALL], ids=["h100", "small"])
@pytest.mark.parametrize("dtype", [BF, F32])
def test_bidir2_plan_covers_every_row_and_unit_once(card, dtype):
    n_sm, limit = card
    for T, R, H in BIDIR2_SHAPES:
        got = L.bidir2_plan(T, R, H, dtype, n_sm, limit)
        route, p = got["route"], got["plan"]
        assert route == ("lstm_scan" if H <= 128 else route)
        if not p["co_resident"]:       # neither wide route fits the small card: the plan says so
            assert card == SMALL and route == "lstm_scan_wide" and H > 128
            assert not L.bidir2_cluster_plan(R, H, dtype, n_sm, limit)["fits"]
            continue
        if route == "lstm_bidir2":
            # a cluster of at most 16 blocks of 32 units a scan and row tile, one wave
            assert p["cluster"] <= 16 and _bidir2_units(p, H) and H > 128
            tiles = _tiles(p, R)
            assert [r for t in tiles for r in t] == list(range(R))       # every row once
            assert p["tile_rows"] in L._BIDIR2["insts"][dtype]
            assert all(0 < len(t) <= p["tile_rows"] for t in tiles) and p["rows"] == max(map(len, tiles))
            assert p["clusters"] == 2 * p["ntiles"] and p["blocks"] == p["clusters"] * p["cluster"]
            # one wave, or more where the wide scan does not fit the card either
            assert p["waves"] == -(-p["clusters"] // (n_sm // p["cluster"]))
            assert p["waves"] == 1 or not L.scan_wide_plan(R, H, dtype, n_sm, limit, 1, 2,
                                                           "lstm_scan_bidir")["co_resident"]
            assert p["smem_bytes"] == L._bidir2_cluster_smem(H, dtype)
            assert p["smem_bytes"] + L._BIDIR2_STATIC_SMEM <= limit
        elif route == "lstm_scan":
            assert p["cluster"] <= 8 and _bidir2_units(p, H)
            tiles = _tiles(p, R)
            assert [r for t in tiles for r in t] == list(range(R))
            assert p["blocks"] == 2 * p["clusters"] * p["cluster"] <= n_sm
        else:
            assert route == "lstm_scan_wide" and H % p["units"] == 0
            groups = _groups(p, R)
            assert [r for g in groups for r in g] == list(range(R))
            assert (p["units"], p["tile_rows"]) in L._bidir2_wide_instances(H, dtype)
            assert p["smem_bytes"] == L._scan_wide_smem(p["units"], p["tile_rows"], H, dtype,
                                                        "lstm_scan_bidir") <= limit
        assert p["tensor_cores"] == (dtype == BF)


def test_bidir2_plan_routes_on_an_h100():
    """GCRN's decode and serving (8 rows, H = 448) take the cluster kernel in both
    dtypes (14 blocks of 32 units a scan); HD-Demucs's H = 768 (24 blocks of 32
    units: no cluster holds it) takes mode kScanBidir of csrc/lstm_scan_wide.cu;
    H <= 128 takes csrc/lstm_scan.cu."""
    routes = {(dt, T, R, H): L.bidir2_plan(T, R, H, dt, *H100)["route"]
              for dt in (BF, F32) for T, R, H in BIDIR2_SHAPES}
    for dt in (BF, F32):
        assert routes[(dt, 1024, 8, 448)] == routes[(dt, 128, 8, 448)] == "lstm_bidir2"
        assert routes[(dt, 1024, 8, 768)] == routes[(dt, 9, 5, 768)] == "lstm_scan_wide"
        assert routes[(dt, 65, 16, 128)] == routes[(dt, 2, 1, 8)] == "lstm_scan"
    p = L.bidir2_plan(1024, 8, 448, BF, *H100)["plan"]
    assert (p["cluster"], p["ntiles"], p["blocks"], p["smem_bytes"]) == (14, 1, 28, 109056)
    # float32: the 8 rows in 2 tiles of 4 (tiles of at least 4 rows, as many as one
    # wave of clusters of 14 holds)
    p = L.bidir2_plan(1024, 8, 448, F32, *H100)["plan"]
    assert (p["cluster"], p["ntiles"], p["tile_rows"], p["blocks"], p["smem_bytes"]) == (
        14, 2, 4, 56, 208384)
    # float32 at H = 768: both directions' groups of 48 blocks of (16 units, 8 rows) in
    # one launch (the other instances' groups of 96 blocks take one launch a direction)
    p = L.bidir2_plan(1024, 8, 768, F32, *H100)["plan"]
    assert (p["units"], p["tile_rows"], p["launch_dirs"], p["blocks"]) == (16, 8, 2, 96)
    assert L.scan_wide_plan(8, 768, F32, *H100, 1, 2, "lstm_scan_bidir")["launch_dirs"] == 1
    # bfloat16 at H = 768: one block an SM (16-unit slices, 96 blocks), not 8-unit
    # slices at two an SM (192)
    p = L.bidir2_plan(1024, 8, 768, BF, *H100, blocks_per_sm=2)["plan"]
    assert (p["units"], p["tile_rows"], p["launch_dirs"], p["blocks"]) == (16, 32, 2, 96)
    # more rows: bfloat16 tiles of 16 rows still one wave at 64 rows (8 clusters of
    # 14), float32 tiles of 8 rows do not (16 clusters): the wide scan
    assert routes[(BF, 5, 64, 512)] == "lstm_bidir2"
    assert L.bidir2_plan(5, 64, 448, F32, *H100)["route"] == "lstm_scan_wide"
    p = L.bidir2_plan(65, 16, 448, F32, *H100)["plan"]
    assert (p["ntiles"], p["rows"], p["tile_rows"]) == (4, 4, 4)


@pytest.mark.parametrize("dtype", [BF, F32])
def test_bidir2_plan_takes_the_wide_scan_where_no_cluster_fits(dtype):
    # H = 768 (24 blocks of 32 units), a card that holds one cluster only, a float32
    # slice past shared memory (H = 512: 240 KB), and the small card's 99 KB a block
    # (the cluster kernel takes 107 KB in bfloat16 at H = 448)
    assert L.bidir2_plan(9, 5, 768, dtype, *H100)["route"] == "lstm_scan_wide"
    assert L.bidir2_plan(9, 5, 448, dtype, *H100, max_clusters=1)["route"] == "lstm_scan_wide"
    cl = L.bidir2_cluster_plan(5, 512, dtype, *H100)
    assert cl["fits"] == (dtype == BF) and cl["cluster"] == 16
    assert not L.bidir2_cluster_plan(8, 448, dtype, *SMALL)["fits"]
    assert L.bidir2_plan(1024, 8, 448, dtype, *SMALL)["route"] == "lstm_scan_wide"


def test_bidir2_cluster_smem_matches_the_kernels_layout():
    # bfloat16 at H = 448: two h buffers of 16 rows x (448 + 8), two sets (by step
    # parity) of the partial sums of 4 k-quarters x 16 rows x 132, the x ring of 3
    # steps x 16 rows x 128
    p = 2 * 4 * 16 * 132 * 4
    assert L._bidir2_cluster_smem(448, BF) == 2 * 16 * 456 * 2 + p + 3 * 16 * 128 * 2
    # float32 at H = 448: slices of 56 k, 32 in registers, 24 x 8 slices x 128 columns
    # in shared memory; two k-major h buffers of 56 x 8 k x 8 rows; two sets of the
    # partial sums of 8 k-slices x 8 rows x 132; the x ring of 3 steps x 4 gates x 8
    # rows x 36
    assert L._bidir2_cluster_smem(448, F32) == (24 * 8 * 128 * 4 + 2 * 56 * 8 * 8 * 4
                                                + 2 * 8 * 8 * 132 * 4 + 3 * 4 * 8 * 36 * 4)
    assert L._bidir2_cluster_smem(136, BF) == 2 * 16 * 152 * 2 + p + 3 * 16 * 128 * 2


# (B, T, H, Bc, dilation): ConvTasNet's decode at every dilation, serving, the
# card tests' ragged shapes (T = 1, d >= the 128-row tile, T < d, 2 Bc over two
# column tiles, H off the 16-byte rows)
TAIL_SHAPES = [(8, 32735, 512, 128, d) for d in (1, 2, 4, 8, 16, 32, 64, 128)] + [
    (8, 4063, 512, 128, 16), (1, 1, 8, 4, 1), (3, 700, 512, 128, 128), (2, 333, 96, 40, 16),
    (2, 100, 64, 200, 300), (2, 77, 12, 3, 5)]


@pytest.mark.parametrize("card", [H100, SMALL], ids=["h100", "small"])
@pytest.mark.parametrize("dtype", [BF, F32])
def test_tail_plan_walks_every_tile_once_within_shared_memory(card, dtype):
    from nvse_tpu_torch.ops import tcn

    n_sm, limit = card
    for B, T, H, Bc, d in TAIL_SHAPES:
        p = tcn.tail_plan(B, T, H, Bc, d, dtype, n_sm, limit)
        assert p["fits"], (B, T, H, Bc, d, p)
        assert (p["kc"], p["stages"]) in tcn._TAIL[dtype]
        assert p["smem_bytes"] == tcn._tail_smem(p["kc"], p["stages"], d, dtype) <= limit
        tiles = B * -(-T // 128) * -(-2 * Bc // 256)
        assert p["tiles"] == tiles and 1 <= p["blocks"] <= min(n_sm, tiles)
        # the persistent blocks walk tiles i, i + blocks, ...: each tile once
        walked = sorted(i + k * p["blocks"] for i in range(p["blocks"])
                        for k in range(-(-(tiles - i) // p["blocks"])))
        assert walked == list(range(tiles))
        # the first instance in the plan's order that fits
        first = next(i for i in tcn._TAIL[dtype] if tcn._tail_smem(*i, d, dtype) <= limit)
        assert (p["kc"], p["stages"]) == first
        assert p["tensor_cores"] == (dtype == BF)


def test_tail_plan_at_convtasnet_decode_on_an_h100():
    from nvse_tpu_torch.ops import tcn

    got = {(dt, d): (p["kc"], p["stages"], p["blocks"], p["tiles"])
           for dt in (BF, F32) for d in (1, 16, 32, 128)
           for p in [tcn.tail_plan(8, 32735, 512, 128, d, dt, *H100)]}
    assert got == {(BF, 1): (64, 3, 132, 2048), (BF, 16): (64, 3, 132, 2048),
                   (BF, 32): (64, 3, 132, 2048), (BF, 128): (32, 3, 132, 2048),
                   (F32, 1): (32, 2, 132, 2048), (F32, 16): (32, 2, 132, 2048),
                   (F32, 32): (32, 2, 132, 2048), (F32, 128): (32, 2, 132, 2048)}
    # nothing fits a card with too little shared memory
    assert not tcn.tail_plan(8, 32735, 512, 128, 128, BF, 132, 64 * 1024)["fits"]


def test_tail_smem_matches_the_kernels_layout():
    from nvse_tpu_torch.ops import tcn

    # bfloat16, chunks of 64 in 3 stages at d = 1: the w_rs chunk 64 x 256, 130 staged rows
    # of 64 + 8 values (rounded to 128 bytes), a and b2 (float32) and w_dw, b_dw (bf16),
    # each stage rounded to 1024 bytes, and 1024 bytes of slack to align the first
    assert tcn._tail_smem(64, 3, 1, BF) == 3 * 53248 + 1024
    assert 64 * 256 * 2 + 18816 + 1024 == 52608 <= 53248
    # d >= 128: three boxes of 128 rows
    assert tcn._tail_smem(32, 3, 300, BF) == 3 * 48128 + 1024
    assert 32 * 256 * 2 + 384 * 40 * 2 + 512 == 47616 <= 48128
    # float32, chunks of 32 in 2 stages at d = 128, then the q tile 32 x 132
    assert tcn._tail_smem(32, 2, 128, F32) == 2 * (32 * 256 * 4 + 384 * 36 * 4 + 768) + 32 * 132 * 4


def test_gln_stats_runs_a_batch_element():
    from nvse_tpu_torch.ops import tcn

    # four blocks an SM over the batch, each run at least 4,096 elements
    assert tcn.gln_stats_partials(8, 32735, 512, 132) == 66
    assert tcn.gln_stats_partials(1, 1, 8, 132) == 1
    assert tcn.gln_stats_partials(3, 700, 96, 132) == 17


@pytest.mark.parametrize("B,T,H", [(8, 4063, 512), (16, 2047, 512), (2, 511, 512),
                                   (8, 32735, 512), (1, 1, 8), (200, 64, 64)])
def test_gln_stats_scratch_holds_the_tickets_and_the_partials(B, T, H):
    """The statistics kernel's scratch (held per card and stream): a ticket a batch element
    and the (B, P, 2) partial sums; P from the SM count, never more blocks a batch
    element than its 4,096-element runs."""
    from nvse_tpu_torch.ops import tcn

    P = tcn.gln_stats_partials(B, T, H, 132)
    assert tcn.gln_stats_scratch(B, P) == (B, 2 * B * P)
    assert 1 <= P <= max(1, -(-T * H // 4096)) and B * P <= max(B, 4 * 132)
    # the ConvTasNet shapes fill the card: about four blocks an SM
    if B * T * H >= 2 ** 22:
        assert B * P >= 3 * 132


def test_gln_stats_scratch_is_held_per_device_and_stream():
    """Every card's default stream has the raw handle 0: the scratch is keyed by
    the device too, so that replicas on two cards never share tickets, and each
    device's scratch lives on it; a larger launch on a stream makes it anew."""
    from nvse_tpu_torch.ops import tcn

    one, other = torch.device("cpu"), torch.device("meta")
    held = dict(tcn._SCRATCH)
    try:
        a = tcn._scratch(one, 0, 2, 3)
        b = tcn._scratch(other, 0, 2, 3)
        assert (one, 0) in tcn._SCRATCH and (other, 0) in tcn._SCRATCH
        assert a[0] is not b[0] and a[1] is not b[1]
        assert {t.device for t in a} == {one} and {t.device for t in b} == {other}
        assert a[0].dtype == torch.int32 and a[1].dtype == torch.float32
        assert not a[0].any() and (a[0].numel(), a[1].numel()) == tcn.gln_stats_scratch(2, 3)
        assert tcn._scratch(one, 0, 1, 3)[0] is a[0]             # a smaller launch reuses it
        assert tcn._scratch(one, 7, 2, 3)[0] is not a[0]         # another stream has its own
        grown = tcn._scratch(one, 0, 4, 3)
        assert grown[0] is not a[0] and grown[1].numel() == 2 * 4 * 3
    finally:
        tcn._SCRATCH.clear()
        tcn._SCRATCH.update(held)


F16 = torch.float16


def test_float16_plans_are_the_bfloat16_instances():
    """float16 runs the bfloat16 layouts of the training kernels (float16
    products): the same instance tables, and the same plans at BSRNN-M's, GCRN's
    and HD-Demucs's training shapes, but for the wide backward's 2 x tile_rows
    ints of row maxima (its carry's scale)."""
    assert L._SCAN[F16] == L._SCAN[torch.bfloat16]
    assert L._BWD_NARROW[F16] == L._BWD_NARROW[torch.bfloat16]
    assert L._SCAN_WIDE[F16] == L._SCAN_WIDE[torch.bfloat16]
    assert L._BWD_WIDE[F16] == L._BWD_WIDE[torch.bfloat16]
    assert L._BWD_MIN_GROUP_ROWS[F16] == L._BWD_MIN_GROUP_ROWS[torch.bfloat16]
    for R, H in ((544, 128), (1040, 128), (16, 448), (63, 768)):
        if H <= 128:
            got = L.scan_narrow_plan(R, H, F16, *H100, mode="lstm_fwd_hc")
            assert got == L.scan_narrow_plan(R, H, torch.bfloat16, *H100, mode="lstm_fwd_hc")
            assert got["co_resident"] and got["tensor_cores"]
            got = L.bwd_narrow_plan(R, H, F16, *H100)
            assert got == L.bwd_narrow_plan(R, H, torch.bfloat16, *H100) and got["co_resident"]
        else:
            got = L.scan_wide_plan(R, H, F16, *H100, 1, 1, "lstm_fwd_hc")
            assert got == L.scan_wide_plan(R, H, torch.bfloat16, *H100, 1, 1, "lstm_fwd_hc")
            assert got["co_resident"] and got["tensor_cores"]
            got = L.bwd_wide_plan(R, H, F16, *H100)
            want = L.bwd_wide_plan(R, H, torch.bfloat16, *H100)
            assert got["co_resident"] and got["tensor_cores"]
            assert {k: v for k, v in got.items() if k != "smem_bytes"} == \
                {k: v for k, v in want.items() if k != "smem_bytes"}
            assert got["smem_bytes"] == want["smem_bytes"] + 2 * got["tile_rows"] * 4


@pytest.mark.parametrize("H", [8, 100, 128, 136, 448, 768, 776, 1024])
def test_float16_training_routes_take_the_resident_kernels_to_768(H):
    """_stepwise and the training routes: float16's lstm_fwd_hc and lstm_bwd take
    the resident kernels (narrow at H <= 128 where the plan runs, else wide) up to
    H = 768 and the step-wise kernel past it; its inference scans and the fused
    route stay on the step-wise kernel at every H; bfloat16 and float32 unchanged."""
    Hp = L.lstm_padding(H)[0]
    past = Hp > L._WIDE_MAX_H
    for name in ("lstm_fwd_hc", "lstm_bwd"):
        assert L._stepwise(H, F16, name) == past
        for narrow_fits in (True, False):
            route = L.train_route(name, Hp, dict(co_resident=narrow_fits), F16)
            want = L._TRAIN_KERNELS[name][0 if Hp <= 128 and narrow_fits else 1]
            assert route == ("lstm_stepwise" if past else want)
            assert route == L.train_route(name, Hp, dict(co_resident=narrow_fits),
                                          torch.bfloat16)
    for name in ("lstm_scan", "lstm_scan_stateful", "lstm_scan_bidir", None):
        assert L._stepwise(H, F16, name)
        assert L._stepwise(H, torch.bfloat16, name) == past
    assert L._fused_route(H, H, dtype=F16) == "projection+lstm_stepwise"
    assert L._kernel_source("lstm_dw_hh", H, F16) == "lstm_bwd"
