"""The decoder-glue kernels' plans, checked on the CPU (the kernels run
only on the card): ``plan_rows`` tiles the row kernel of ``assemble_z``,
``se_squeeze`` and ``assemble`` so that a block's staged half-resolution
rows and columns hold every tap the tap table names, within the shared
memory it counts; ``plan_gate_z`` and a model of ``gate_z``'s walk store
exactly the z block of every pixel, once."""

import numpy as np
import pytest

from uncertainty_model_tpu_torch.ops import decoder_fused as tdf

# (H, W, Cso, Cu, Cd, cf): the flagship's fused stages at 256x512 and the
# tiny config's at 32x64
FLAGSHIP = {
    "dec2": (64, 128, 128, 32, 4, 0),
    "dec3": (128, 256, 64, 16, 4, 0),
    "dec4": (256, 512, 32, 8, 4, 3),
}
TINY = {
    "tiny_dec2": (8, 16, 16, 4, 4, 0),
    "tiny_dec3": (16, 32, 16, 4, 4, 0),
    "tiny_dec4": (32, 64, 16, 4, 4, 3),
}
# ragged shapes: odd Cso and Ccat, one half-resolution row or column, a
# width that a column tile does not divide
RAGGED = {
    "odd_cso": (6, 10, 5, 3, 1, 0),
    "one_row": (2, 6, 16, 4, 4, 3),
    "one_column": (8, 2, 8, 4, 0, 0),
    "cso48": (10, 18, 48, 4, 4, 0),
}
# the flagship's stages that run the glue only under other build options:
# dec0 and dec1 under fused_stages=(0, ..., 4) (no disparity to concat),
# dec4 under dec_fold=False (the SE conv's feature-map half outside)
OPTION_STAGES = {
    "dec0": (16, 32, 512, 128, 0, 0),
    "dec1": (32, 64, 256, 64, 0, 0),
    "dec4_nofold": (256, 512, 32, 8, 4, 0),
}
ALL = {**FLAGSHIP, **OPTION_STAGES, **TINY, **RAGGED}
MODES = sorted(tdf.ROW_MODES)


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("stage", sorted(ALL))
def test_plan_rows_fits_and_covers_the_taps(stage, mode, itemsize):
    h, w, cso, cu, cd, cf = ALL[stage]
    plan = tdf.plan_rows(h, w, cso, cu, cd, cf, itemsize, mode)
    g = cso // plan.vec
    assert cso % plan.vec == 0 and plan.threads % g == 0
    assert plan.threads <= 1024 and plan.rows == 2
    blocks = tdf.ROW_BLOCKS_PER_SM if plan.vec > 1 else 1
    assert plan.smem + 1024 <= tdf.SM_SMEM // blocks
    assert plan.cols % 2 == 0 and plan.tiles == -(-w // plan.cols)
    assert plan.halo_cols >= min(plan.cols // 2 + 2, w // 2)
    r0, s0, ncur = tdf.row_staging(plan, h, w)
    assert (ncur <= plan.halo_cols).all()
    for bf16 in (False, True):
        taps = tdf.tap_table(h, w, bf16)
        rows, cols = taps[:h], taps[h:]
        for k in (0, 1):  # lo, hi: inside the staged rows and columns
            assert ((rows[:, k] >= r0) & (rows[:, k] <= np.minimum(
                r0 + 2, h // 2 - 1))).all()
            assert ((cols[:, k] >= s0) & (cols[:, k] < s0 + ncur)).all()


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("stage", sorted(ALL))
def test_plan_rows_tiles_alike_in_every_mode(stage, itemsize):
    """se_squeeze, assemble_z and assemble cut a stage into the same blocks
    with the same threads, so their SE sums are added in one order."""
    h, w, cso, cu, cd, cf = ALL[stage]
    plans = [tdf.plan_rows(h, w, cso, cu, cd, cf, itemsize, mode)
             for mode in MODES]
    assert len({(p.cols, p.threads, p.vec) for p in plans}) == 1


@pytest.mark.parametrize("stage", sorted(FLAGSHIP))
def test_plan_rows_flagship_bf16(stage):
    """bf16 at the flagship's stages: whole rows (three skip rows of 48 KB),
    16-byte vectors, two blocks an SM."""
    h, w, cso, cu, cd, cf = FLAGSHIP[stage]
    smem = {"dec2": 100_880, "dec3": 103_440, "dec4": 108_944}[stage]
    plan = tdf.plan_rows(h, w, cso, cu, cd, cf, 2, "assemble_z")
    assert plan == tdf.RowPlan(2, w, w // 2, 256, 8, smem, 1)
    squeeze = tdf.plan_rows(h, w, cso, cu, cd, cf, 2, "se_squeeze")
    assert squeeze.cols == w and squeeze.smem < plan.smem
    assert 2 * (plan.smem + 1024) <= tdf.SM_SMEM


def test_plan_rows_f32_tiles_columns():
    """f32 at dec4: three whole skip rows would take 96 KB, so the row is
    cut into two tiles of 256 columns with a 1-column halo on each side."""
    h, w, cso, cu, cd, cf = FLAGSHIP["dec4"]
    plan = tdf.plan_rows(h, w, cso, cu, cd, cf, 4, "assemble_z")
    assert (plan.cols, plan.tiles, plan.halo_cols, plan.vec) == (256, 2, 130, 4)
    r0, s0, ncur = tdf.row_staging(plan, h, w)
    assert sorted(set(s0)) == [0, 127] and sorted(set(ncur)) == [129]


@pytest.mark.parametrize("stage,itemsize,cols,halo,vec,tiles", [
    ("dec0", 2, 32, 16, 8, 1), ("dec0", 4, 8, 6, 4, 4),
    ("dec1", 2, 64, 32, 8, 1), ("dec1", 4, 16, 10, 4, 4),
    ("dec4_nofold", 2, 512, 256, 8, 1), ("dec4_nofold", 4, 256, 130, 4, 2),
])
def test_plan_rows_option_stages(stage, itemsize, cols, halo, vec, tiles):
    """The tiles the card gets at dec0, dec1 and dec4 without the fold, in
    every mode: bf16 whole rows; f32 at dec0 and dec1 column tiles of 8
    and 16 (three staged skip rows of 512 or 256 f32 channels would take
    more than their share of shared memory), and at dec4 two tiles as
    with the fold."""
    h, w, cso, cu, cd, cf = OPTION_STAGES[stage]
    for mode in MODES:
        plan = tdf.plan_rows(h, w, cso, cu, cd, cf, itemsize, mode)
        assert (plan.cols, plan.halo_cols, plan.threads, plan.vec,
                plan.tiles) == (cols, halo, 256, vec, tiles), mode
    if tiles > 1:
        r0, s0, ncur = tdf.row_staging(plan, h, w)
        assert sorted(set(s0)) == [max(c // 2 - 1, 0)
                                   for c in range(0, w, cols)]
        assert ncur.max() <= halo


def test_plan_rows_unaligned_se_fm():
    """se_fm off 16 bytes: one channel a thread (unless the stage folds a
    narrow feature map, read a channel at a time anyway), the same tiles."""
    h, w, cso, cu, cd, cf = FLAGSHIP["dec3"]
    aligned = tdf.plan_rows(h, w, cso, cu, cd, cf, 2, "assemble")
    plan = tdf.plan_rows(h, w, cso, cu, cd, cf, 2, "assemble", False)
    assert (plan.vec, plan.threads, plan.cols) == (1, 256, aligned.cols)
    folded = tdf.plan_rows(*FLAGSHIP["dec4"], 2, "assemble", se_aligned=False)
    assert folded.vec == 8


def test_plan_rows_odd_channels():
    plan = tdf.plan_rows(*RAGGED["odd_cso"], 2, "assemble_z")
    assert plan.vec == 1 and plan.threads == 255


# ---------------------------------------------------------------------------
# gate_z


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("stage", sorted({**FLAGSHIP, **OPTION_STAGES}))
def test_gate_z_walk_stores_the_z_block_once(stage, itemsize):
    """The flagship's stages (dec0 and dec1: Ccat 640 and 320), a slab cut
    for 1, 12 and 17 blocks (at batch 64 an H100 holds 12 blocks a slab at
    once)."""
    h, w, cso, cu, cd, _ = {**FLAGSHIP, **OPTION_STAGES}[stage]
    ccat = cso + cu + cd
    plan = tdf.plan_gate_z(64, h, w, ccat, itemsize)
    assert (plan.vec, plan.threads, plan.in_flight) == (16 // itemsize, 256,
                                                        4)
    n = h * w * ccat
    for per_batch in (1, 12, 17):
        chunk, blocks = tdf.gate_z_chunk(plan, n, per_batch)
        assert chunk % plan.vec == 0 and blocks <= per_batch
        stores = tdf.gate_z_walk(plan, n, ccat, cso, per_batch=per_batch)
        np.testing.assert_array_equal(stores, np.arange(n) % ccat < cso)


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("shape", [(3, 5, 7, 3), (2, 2, 5, 4), (1, 3, 3, 1),
                                   (4, 6, 24, 16), (2, 4, 21, 21),
                                   (8, 40, 9, 5)])
def test_gate_z_walk_unaligned_slabs(shape, itemsize):
    """Odd Ccat at small W, whole-z pixels (Cso == Ccat), slabs cut for 1-4
    blocks, and every start of the slab within a 16-byte vector: the
    ragged heads and tails element by element, the rest by vectors, each z
    lane stored once and nothing else."""
    h, w, ccat, cso = shape
    n = h * w * ccat
    plan = tdf.plan_gate_z(1, h, w, ccat, itemsize)
    for per_batch in (1, 2, 4):
        for misalign in range(plan.vec):
            stores = tdf.gate_z_walk(plan, n, ccat, cso, misalign, per_batch)
            np.testing.assert_array_equal(stores, np.arange(n) % ccat < cso)


def test_plan_gate_z_refuses_what_it_cannot_hold():
    with pytest.raises(ValueError, match="2\\^31"):
        tdf.plan_gate_z(1, 4096, 4096, 200, 2)
    with pytest.raises(ValueError, match="shared memory"):
        tdf.plan_gate_z(1, 2, 2, 8000, 2)
    assert tdf.plan_gate_z(1, 2, 2, 7000, 2).vec == 8
