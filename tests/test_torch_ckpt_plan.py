"""The launch plan of the checkpointed kernels K4/K5 (csrc/fused_ckpt.cu),
computed on the host by ``ckpt_plan`` as the kernel's ``make_plan``
computes it: the tile, the jobs of each product phase, the grid, the grid
barriers per step and the shared memory of a block, on an H100's 132 SMs.
chip_smoke.py holds it against the kernel's own plan and barrier count on
the card.
"""

import pytest

from pulser_diff_torch.ops import fused_evolution as tfe

SMS = 132
S = 6  # DP5
# atoms -> da = db (one global channel: two row and two column parts)
DIMS = {12: 64, 14: 128, 16: 256}


@pytest.mark.parametrize("bwd", [False, True], ids=["K4", "K5"])
@pytest.mark.parametrize("nb", [1, 3])
@pytest.mark.parametrize("K", [0, 8, 32])
@pytest.mark.parametrize("atoms", [12, 14, 16])
def test_plan_invariants(atoms, K, nb, bwd):
    """One block per SM at most, never more blocks than the largest phase
    has jobs; one grid barrier per application of -iH (two with kron
    pairs); the ring and exchange tiles fit a block's shared memory."""
    d = DIMS[atoms]
    plan = tfe.ckpt_plan(bwd, 1, nb, d, d, K, S, SMS)
    assert 1 <= plan["blocks"] <= SMS and plan["blocks"] <= plan["jobs_max"]
    assert plan["jobs_max"] == max(plan["jobs"].values())
    assert set(plan["jobs"]) == (
        ({"forward", "reverse"} if bwd else {"apply"})
        | ({"forward_kron", "reverse_kron"} if bwd and K else {"apply_kron"} if K else set()))
    apps = 2 * S - 1 if bwd else S
    assert plan["barriers_per_step"] == apps * (2 if K else 1)
    if not K:  # the design's bounds: K4 at most S, K5 at most 2S + 1
        assert plan["barriers_per_step"] <= (2 * S + 1 if bwd else S)
    assert plan["smem_bytes"] == 102912 <= tfe._SMEM_LIMIT


@pytest.mark.parametrize(
    "atoms, tile, apply_jobs",
    [(16, (32, 16), 128), (14, (16, 8), 128), (12, (16, 8), 32)],
    ids=["16-atoms", "14-atoms", "12-atoms"],
)
def test_tile_fills_the_card(atoms, tile, apply_jobs):
    """32 x 16 where those tiles come to three quarters of the SMs (16
    atoms: 128 jobs), else 16 x 8 (14 atoms: 128 jobs; 12 atoms: 32)."""
    d = DIMS[atoms]
    plan = tfe.ckpt_plan(False, 1, 1, d, d, 0, S, SMS)
    assert plan["tile"] == tile and plan["jobs"]["apply"] == apply_jobs
    assert plan["blocks"] == min(apply_jobs, SMS)


def test_sixteen_atom_main_path():
    """K4: 128 apply jobs on 128 blocks, S barriers a step; K5: 128 apply
    jobs plus 64 + 64 outer-product double tiles (64 x 16) in each reverse
    phase, on all 132 SMs, 2S - 1 barriers a step."""
    k4 = tfe.ckpt_plan(False, 1, 1, 256, 256, 0, S, SMS)
    k5 = tfe.ckpt_plan(True, 1, 1, 256, 256, 0, S, SMS)
    assert k4["jobs"] == {"apply": 128} and k4["blocks"] == 128 and k4["barriers_per_step"] == 6
    assert k5["jobs"] == {"forward": 128, "reverse": 256}
    assert k5["blocks"] == 132 and k5["barriers_per_step"] == 11


def test_twelve_atom_xy_shapes():
    """12 atoms XY with ckpt=True (K = 8): 32 tiles of 16 x 8; the R-side
    products of 8 terms (R and R^T) on 16 double tiles each; K5 adds the
    part-matrix cotangents' 4 first products a term and their 8 + 8
    double tiles of (da, da) and (db, db) a term."""
    k4 = tfe.ckpt_plan(False, 1, 1, 64, 64, 8, S, SMS)
    assert k4["tile"] == (16, 8)
    assert k4["jobs"] == {"apply": 32 + 2 * 8 * 16, "apply_kron": 32}
    assert k4["blocks"] == SMS and k4["barriers_per_step"] == 12
    k5 = tfe.ckpt_plan(True, 1, 1, 64, 64, 8, S, SMS)
    outer = 2 * 2 * 8
    assert k5["jobs"] == {"forward": 32 + 256, "forward_kron": 32,
                          "reverse": 32 + 256 + 4 * 8 * 16 + outer, "reverse_kron": 32 + 8 * outer}
    assert k5["barriers_per_step"] == 22


def test_runs_and_state_batches_scale_the_jobs():
    """Two runs double every phase's jobs (and may take a larger tile);
    the state batch multiplies only the kron jobs, since a tile's job loops
    over the states."""
    one = tfe.ckpt_plan(True, 1, 1, 128, 128, 8, S, SMS)
    three = tfe.ckpt_plan(True, 1, 3, 128, 128, 8, S, SMS)
    assert three["jobs"]["forward_kron"] == one["jobs"]["forward_kron"]
    assert three["jobs"]["forward"] > one["jobs"]["forward"]
    two_runs = tfe.ckpt_plan(False, 2, 1, 256, 256, 0, S, SMS)
    assert two_runs["jobs"]["apply"] == 256 and two_runs["blocks"] == SMS


def test_smaller_cards_take_smaller_grids():
    """The grid follows the SM count it is given: never more blocks than
    SMs, and a larger tile where fewer SMs are to be filled."""
    small = tfe.ckpt_plan(False, 1, 1, 128, 128, 0, S, 16)
    assert small["tile"] == (32, 16) and small["blocks"] == 16
