"""The launch plan of the cluster kernels K1/K2 (csrc/fused_evolution.cu):
the cluster size C and the shared memory of a block, computed on the host
by the same formula as the kernel's ``smem_floats``, for the shapes the
main paths and the tests run, and the refusal past the limit.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from pulser_diff_torch.ops import fused_evolution as tfe

torch.set_num_threads(1)

# the 12-atom main paths: da = db = 64, one global channel (pr = pc = 2),
# DP5 (S = 6); the XY path adds K = 8 kron pairs
MAIN = dict(nb=1, da=64, db=64, pr=2, pc=2, S=6)


@pytest.mark.parametrize("bwd", [False, True], ids=["K1", "K2"])
@pytest.mark.parametrize("K", [0, 8, 32])
def test_twelve_atom_shapes_fit_a_cluster(bwd, K):
    C, smem = tfe.cluster_plan(bwd, MAIN["nb"], MAIN["da"], MAIN["db"], MAIN["pr"], MAIN["pc"],
                               K, MAIN["S"])
    assert C == 16 and smem <= tfe._SMEM_LIMIT
    assert smem == 4 * tfe._smem_floats(bwd, 1, 64, 64, 2, 2, K, 6, C)


def test_smem_formula_counts_every_region():
    """K1 at 12 atoms, C = 8 (8 rows a block): Hcol 2*64*64, Hrow rows
    2*8*64, the gathered vector 2*64*65, two published slab pairs 4*512,
    X, Y, CX, CY and 6 stage pairs 16*512 floats, and the stage's stream
    words 4*(pr + pc)."""
    slab = 8 * 64
    want = 2 * 64 * 64 + 2 * 8 * 64 + 2 * 64 * 65 + 4 * slab + 16 * slab + 4 * (2 + 2)
    assert tfe._smem_floats(False, 1, 64, 64, 2, 2, 0, 6, 8) == want
    # K1 with K = 8: the kron staging (2K streams, R rows and columns, C
    # padded, 8 product slabs); K2 also the costate, S more pairs, the
    # stage input gathered and the reduction rows (8 warps + 2) x
    # (2pr + 2pc + 2K)
    kron = 2 * 8 + 2 * 8 * 64 + 64 * 65 + 8 * slab
    assert tfe._smem_floats(False, 1, 64, 64, 2, 2, 8, 6, 8) == want + kron
    want2 = want + 2 * 6 * slab + kron + 2 * 64 * 65 + 10 * (4 + 4 + 16)
    assert tfe._smem_floats(True, 1, 64, 64, 2, 2, 8, 6, 8) == want2


@pytest.mark.parametrize("n_atoms", [2, 3, 4, 5, 6])
def test_small_test_shapes_fit(n_atoms):
    """Every split da * db = 2^n of the 2-6-atom test shapes, with state
    batches up to 3, both tableaus, up to n(n-1)/2 kron pairs."""
    for a in range(1, n_atoms):
        da, db = 2**a, 2 ** (n_atoms - a)
        for nb in (1, 2, 3):
            for S in (4, 6):
                for K in (0, n_atoms * (n_atoms - 1) // 2):
                    for bwd in (False, True):
                        C, smem = tfe.cluster_plan(bwd, nb, da, db, 2, 2, K, S)
                        assert C == min(da, 16) and smem <= tfe._SMEM_LIMIT


# the launch's own rule, as csrc/fused_evolution.cu writes it in plan_ok
_PLAN_OK_LINE = "if (C < 1 || C > MAX_C || (C & (C - 1)) || da % C) return -6;"


def _plan_ok(bwd, nb, da, db, pr, pc, K, S, C) -> bool:
    """plan_ok of csrc/fused_evolution.cu, line for line."""
    if C < 1 or C > 16 or (C & (C - 1)) or da % C:
        return False
    return 4 * tfe._smem_floats(bwd, nb, da, db, pr, pc, K, S, C) <= 232448


def test_cluster_size_is_a_power_of_two_that_divides_da():
    """C is the largest power of two, at most 16, that divides da: min(da,
    16) for 2^a and 4^a, 1 for 3^a (the all basis); cluster_fits is the
    launch's rule, plan_ok, at that C, for every shape of 2^a, 3^a and 4^a
    rows and columns, so that routing never passes a shape the launch
    refuses."""
    src = (Path(__file__).resolve().parents[1] / "pulser_diff_torch" / "csrc"
           / "fused_evolution.cu").read_text()
    assert _PLAN_OK_LINE in src
    for da in (2, 4, 8, 16, 64, 128, 256):
        C = tfe._cluster_size(da)
        assert C & (C - 1) == 0 and da % C == 0 and C == min(da, 16)
    for da in (3, 9, 27, 81, 243):
        assert tfe._cluster_size(da) == 1
    assert (tfe._cluster_size(3), tfe._cluster_size(81), tfe._cluster_size(64)) == (1, 1, 16)
    shapes = [(d**a, d**b) for d in (2, 3, 4) for a in range(1, 9) for b in (a, a + 1)
              if d**(a + b) <= 2**18]
    for da, db in shapes:
        for nb, K, pr in ((1, 0, 2), (2, 0, 4), (1, 3, 2)):
            for bwd in (False, True):
                args = (bwd, nb, da, db, pr, pr, K, 6)
                ok = _plan_ok(*args, tfe._cluster_size(da))
                assert tfe.cluster_fits(*args) == ok, (da, db, nb, K, bwd)
                if ok:
                    assert tfe.cluster_plan(*args)[0] == tfe._cluster_size(da)
                else:
                    with pytest.raises(ValueError, match="ckpt=True"):
                        tfe.cluster_plan(*args)


@pytest.mark.parametrize("n_atoms", [2, 3, 4, 5, 6, 7, 8, 10])
def test_all_basis_shapes(n_atoms):
    """The all basis (3 levels a site): one block a run (C = 1); K1 and K2
    hold up to 6 atoms (27 x 27) and refuse from 7 (27 x 81), before any
    launch."""
    a = n_atoms // 2
    da, db = 3**a, 3 ** (n_atoms - a)
    for bwd in (False, True):
        fits = tfe.cluster_fits(bwd, 1, da, db, 4, 4, 0, 6)
        assert fits == (n_atoms <= 6)
        if fits:
            assert tfe.cluster_plan(bwd, 1, da, db, 4, 4, 0, 6)[0] == 1


def test_state_batches_at_twelve_atoms():
    """16 blocks of 4 rows: K1 takes up to nb = 3, K2 up to nb = 2."""
    for bwd, most in ((False, 3), (True, 2)):
        for nb in range(1, most + 1):
            assert tfe.cluster_plan(bwd, nb, 64, 64, 2, 2, 0, 6)[0] == 16


@pytest.mark.parametrize(
    "bwd, nb, da, db, most",
    [(False, 4, 64, 64, "up to nb=3"), (True, 3, 64, 64, "up to nb=2"),
     (False, 1, 128, 128, "no state batch"), (True, 1, 128, 128, "no state batch")],
    ids=["K1-12-atoms-nb4", "K2-12-atoms-nb3", "K1-14-atoms", "K2-14-atoms"],
)
def test_past_the_limit_raises_naming_ckpt(bwd, nb, da, db, most):
    with pytest.raises(ValueError, match="ckpt=True") as err:
        tfe.cluster_plan(bwd, nb, da, db, 2, 2, 0, 6)
    assert most in str(err.value)


def test_fused_plan_of_staged_inputs():
    """The plan of a staged data dict: C blocks per run, one cluster per
    run."""
    R, nb, da, db, n_steps, S, K = 2, 1, 4, 8, 3, 6, 2
    data = {"psi_re": torch.zeros(R, nb, da, db), "hs": torch.zeros(n_steps),
            "rp": torch.zeros(2, da, da), "cp": torch.zeros(2, db, db),
            "kr": torch.zeros(R, K, da, da)}
    plan = tfe.fused_plan(data, "DP5", bwd=True)
    assert plan["C"] == plan["blocks_per_run"] == 4 and plan["runs"] == R
    assert plan["smem_bytes"] == 4 * tfe._smem_floats(True, nb, da, db, 2, 2, K, S, 4)
    assert np.isclose(tfe.fused_plan(data, "RK4", bwd=False)["smem_bytes"],
                      4 * tfe._smem_floats(False, nb, da, db, 2, 2, K, 4, 4))


_PTXAS = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z16fused_bwd_kernelILb1EEvPKfS1_' for 'sm_90a'
ptxas info    : Function properties for _Z16fused_bwd_kernelILb1EEvPKfS1_
    8 bytes stack frame, 24 bytes spill stores, 60 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 1400 bytes cmem[0]
ptxas info    : Compiling entry function '_Z16fused_fwd_kernelILb0EEvPKfS1_' for 'sm_90a'
ptxas info    : Function properties for _Z16fused_fwd_kernelILb0EEvPKfS1_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers, 1400 bytes cmem[0]
ptxas info    : Function properties for _Z9group_mmaILi0ELi2ELi2EEvR9GroupSmemiPK3Src
    0 bytes stack frame, 16 bytes spill stores, 8 bytes spill loads
"""


def test_ptxas_summary_of_the_build_log():
    """chip_smoke.py's reading of ptxas -v: registers and spill bytes per
    kernel instantiation and per out-of-line device function."""
    import chip_smoke

    got = {chip_smoke._instantiation(k): v for k, v in chip_smoke._ptxas_summary(_PTXAS).items()}
    assert got == {"fused_bwd_kernel<true>": [255, 24, 60], "fused_fwd_kernel<false>": [96, 0, 0],
                   "_Z9group_mmaILi0ELi2ELi2EEvR9GroupSmemiPK3Src": [None, 16, 8]}


@pytest.mark.parametrize("source", ["fused_evolution", "fused_ckpt"])
def test_kernel_phases_edits_match_the_source(source):
    """kernel_phases.py compiles one phase of csrc/fused_evolution.cu (K1/K2)
    or csrc/fused_ckpt.cu (K4/K5) out by text edits: each must still find
    its line."""
    import kernel_phases
    from pulser_diff_torch.ops import kernel_build

    src = (kernel_build.CSRC / f"{source}.cu").read_text()
    variants = kernel_phases.VARIANTS if source == "fused_evolution" else kernel_phases.CKPT_VARIANTS
    for name, edits in variants.items():
        for old, _ in edits:
            assert old in src, (name, old)


@pytest.mark.parametrize("bwd", [False, True], ids=["K1", "K2"])
@pytest.mark.parametrize("P", [12, 32])
def test_per_qubit_parts_keep_the_state_batches(bwd, P):
    """A per-qubit build's parts (12 a side at 12 atoms, up to the 32 the
    kernels take) add 4 (pr + pc) stream words a block, and K2 (8 warps +
    2) x (2pr + 2pc) reduction floats: at 12 atoms K1 still takes nb = 3
    and K2 nb = 2."""
    most = 2 if bwd else 3
    C, smem = tfe.cluster_plan(bwd, most, 64, 64, P, P, 0, 6)
    assert C == 16 and smem == 4 * tfe._smem_floats(bwd, most, 64, 64, P, P, 0, 6, 16)
    assert smem <= tfe._SMEM_LIMIT
