"""The launch plans of the two redesigned kernels, on the CPU.

`dw_plan` (the dW_hh reduction of csrc/lstm_bwd.cu) and `fused_wide_plan` (the
wide fused BiLSTM of csrc/lstm_fused_wide.cu) are plain functions of the shape,
the dtype and the card's SM count, shared-memory limit and blocks per SM; the
C entries take their plans as arguments. Checked here at an H100's figures
(132 SMs, 232,448 bytes a block) and at a smaller card's (46 SMs, 101,376
bytes): every (row, step) pair in exactly one dW split, each tile and ring in
the shared-memory limit, the fused grid co-resident or the plan saying it is
not, and the plans the port reports for BSRNN-L's shapes and the H = 136, 448
and 512 edges.
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
