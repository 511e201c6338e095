"""The layout probes P1-P4 (utils/probes.py, csrc/probe_*.cu) on the CPU:
each twin against its probe's own Pallas body, run in interpret mode over
one grid step by tests/torch_probe_loader.py (which never imports
scripts/probe_*.py), at every shape the probe runs, on the probe's
inputs and on a seeded variant. On the card, chip_smoke.py phase 23 and
tests/test_torch_cuda.py hold each kernel to its twin.

Tolerances, with their reasons (measured on the CPU):
- P3 C and D: bit for bit. C's one-hot product has one nonzero term, so
  it is the gathered value and the eight adds run in the body's order;
  D's terms are integers whose sums stay below 2^24.
- P2: within TABLE_RTOL of the table's largest entry (the fused kernels'
  gradient-table tier). The JAX body sums each bounce's product before it
  adds it to the table; the twin adds in the kernel's order. Measured:
  A 9.8e-7, B 1.2e-7 of the largest entry (2 044 802 and 255 600).
- P4: XLA contracts a * b + c into fused multiply-adds inside the
  interpret-mode jit, and its rsqrt is within 2 ulp of 1 / sqrt. While a
  ray hits, its chain doubles an angle each segment (the new origin is d
  reflected about the plane normal to the old one: theta' = pi - 2 theta),
  so such a difference doubles each segment; a ray that misses turns NaN
  and adds a constant after that. At the probe's inputs every ray misses
  by its third segment: bit for bit at 64 segments (measured). At
  P4_SEED, rays live at most 23 segments: measured bit for bit at every
  shape; allowed P4_SEED_ULP ulps on at most P4_SEED_FRAC of the lanes. A
  seed whose rays hit for all 64 segments differs from the JAX body on
  every lane (the doubling), but not from the kernel (both round each
  operation: chip_smoke.py).
- P1: XLA contracts y * 1.000001 + x. The twin with `contract=True` (one
  rounding) equals the JAX body bit for bit over the 2 000 steps at every
  shape and input (measured); the kernel's twin (two roundings) equals it
  at the probe's x = 0.5 (measured) and, at the seeded x, within 1 ulp
  after one step; over 2 000 steps the wrap at 2 turns that ulp into any
  difference.
"""

import numpy as np
import pytest
import torch

import torch_probe_loader as loader
from tinyraytracer_tpu_torch.utils import probes as pr
from tinyraytracer_tpu_torch.utils import profiling, sol

TABLE_RTOL = 1e-5
P4_SEED = pr.P4_SEED_SHORT
P4_SEED_ULP = 4
P4_SEED_FRAC = 0.01
P3_SEED = 3
P1_SEED = 1


@pytest.fixture(scope="module", autouse=True)
def single_thread_torch():
    # the twins launch thousands of small ops: torch's thread pool only
    # adds contention beside the suite's other workers
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _ulps(a, b) -> np.ndarray:
    a = np.ascontiguousarray(a, np.float32)
    b = np.ascontiguousarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def _bits(a, b) -> bool:
    return bool((_ulps(a, b) == 0).all())


# --- P2 -------------------------------------------------------------------------

@pytest.fixture(scope="module")
def p2():
    ns = loader.load("probe_packgrad")
    jax_out = {b: loader.call(ns[f"kernel_{b}"], pr.TABLE) for b in "AB"}
    twin = {b: pr.packgrad(b, "cpu").numpy() for b in "AB"}
    return jax_out, twin


@pytest.mark.parametrize("body", ["A", "B"])
def test_packgrad_twin_matches_the_jax_body(p2, body):
    jax_out, twin = p2
    top = float(np.abs(jax_out[body]).max())
    assert top > 2e5
    assert float(np.abs(twin[body] - jax_out[body]).max()) <= TABLE_RTOL * top
    zero = np.ones(pr.TABLE, bool)
    if body == "A":
        zero[:, :pr.P2_K] = False
    else:
        zero[0, :2 * pr.NA] = False
    assert not twin[body][zero].any() and twin[body][~zero].all()


def test_packgrad_tables_cross_check(p2):
    """Columns 0 and 1 of A's table are B's row 0 interleaved: the sums
    of c and 2c over each row."""
    _, twin = p2
    a, b = twin["A"], twin["B"]
    assert float(np.abs(a[:, :2].reshape(-1) - b[0, :2 * pr.NA]).max()) \
        <= TABLE_RTOL * float(np.abs(a).max())


def test_packgrad_scatter_orders_differ_by_rounding_alone():
    """The kernel's order (a row's lanes summed in lane order, then added
    to the row) against the order in turns (each lane adding into the
    row): within TABLE_RTOL of the largest entry, not the same bits."""
    new = pr.packgrad_reference("A", "cpu", bounces=3)
    turns = pr.packgrad_reference("A", "cpu", bounces=3, turns=True)
    assert not torch.equal(new, turns)
    assert float((new - turns).abs().max()) <= TABLE_RTOL * float(
        turns.abs().max())
    with pytest.raises(ValueError, match="turns"):
        pr.packgrad_reference("B", "cpu", turns=True)


def test_packgrad_scatter_at_another_bounce_count():
    """P2 has no input: the bounce count is what varies (3, through the
    loader's constant)."""
    ns = loader.load("probe_packgrad", B=3)
    want = loader.call(ns["kernel_A"], pr.TABLE)
    got = pr.packgrad_reference("A", "cpu", bounces=3).numpy()
    assert float(np.abs(got - want).max()) <= TABLE_RTOL * float(
        np.abs(want).max())


# --- P3 -------------------------------------------------------------------------

@pytest.fixture(scope="module")
def p3():
    return loader.load("probe_packgrad2")


@pytest.mark.parametrize("seed", [None, P3_SEED], ids=["probe", "seeded"])
def test_packgrad2_gather_bit_for_bit(p3, seed):
    pay = pr.packgrad2_inputs(seed)
    want = loader.call(p3["kernel_C"], pr.P3_SHAPE, pay.numpy())
    got = pr.packgrad2("C", pay)
    assert tuple(got.shape) == pr.P3_SHAPE
    assert _bits(got.numpy(), want)
    if seed is None:
        assert (want == 128.0).all()     # 16 bounces x 8 fields of 1.0


def test_packgrad2_table_bit_for_bit(p3):
    want = loader.call(p3["kernel_D"], pr.TABLE)
    got = pr.packgrad2("D", device="cpu").numpy()
    assert _bits(got, want)
    assert float(want.max()) == 1468416.0 and want.max() < 2**24
    assert not got[4:].any() and not got[:, 4:].any()


def test_a_wrong_gather_index_changes_the_seeded_output(p3, monkeypatch):
    """At the probe's all-ones pay no index can be wrong; at the seeded
    pay a gather one column off changes every lane."""
    seeded = pr.packgrad2_inputs(P3_SEED)
    ones = pr.packgrad2_inputs(None)
    right = pr.packgrad2("C", seeded)
    right_ones = pr.packgrad2("C", ones)
    monkeypatch.setattr(pr, "gather_index",
                        lambda rows, b: (rows + b + 1) % pr.NA)
    assert bool((pr.packgrad2("C", seeded) != right).all())
    assert torch.equal(pr.packgrad2("C", ones), right_ones)


# --- P4 -------------------------------------------------------------------------

P4_CASES = [(b, s, seed) for seed in (None, P4_SEED)
            for b, shapes in (("A", pr.P4_A_SHAPES), ("B", pr.P4_B_SHAPES))
            for s in shapes]


@pytest.fixture(scope="module")
def p4():
    """The JAX bodies' outputs of every case; the eight shapes trace and
    compile side by side (XLA's compile runs outside the GIL)."""
    from concurrent.futures import ThreadPoolExecutor

    ns = loader.load("probe_seglayout")

    def run(body, shape, seed):
        tab = pr.seglayout_inputs(seed)
        if body == "A":
            return loader.call(ns["kernel_A"], shape, tab["sc"].numpy(),
                               tab["pay"].numpy())
        return loader.call(ns["kernel_B"], shape, tab["smem"].numpy())

    first = [c for c in P4_CASES if c[2] is None]
    with ThreadPoolExecutor(4) as pool:
        out = dict(zip(first, pool.map(lambda c: run(*c), first)))
    out.update({c: run(*c) for c in P4_CASES if c[2] is not None})
    return out


@pytest.mark.parametrize("body,shape,seed", P4_CASES, ids=[
    f"{b}-{s[0]}x{s[1]}-{'probe' if seed is None else 'seeded'}"
    for b, s, seed in P4_CASES])
def test_seglayout_twin_matches_the_jax_body(p4, body, shape, seed):
    want = p4[body, shape, seed]
    got = pr.seglayout(body, shape, pr.seglayout_inputs(seed)).numpy()
    assert got.shape == tuple(shape) and np.isfinite(got).all()
    u = _ulps(got, want)
    if seed is None:
        assert u.max() == 0
    else:
        assert (u > P4_SEED_ULP).mean() <= P4_SEED_FRAC, u.max()


def test_seglayout_states_at_the_probe_inputs_and_the_seed():
    """At the probe's inputs every ray hits in its first segment or
    none, then misses: its origin is NaN from segment 2 or 3 on, 62 or 63
    of 64 segments. At the seed the winner varies and a share of rays
    hits for several segments; B's material ids pick several albedos."""
    st = {}
    pr.seglayout_reference("A", (1, 1024), pr.seglayout_inputs(), stats=st)
    assert set(st["nan_segments"].unique().tolist()) <= {62, 63}
    assert st["hits"][1:] == [0] * (pr.P4_SEGMENTS - 1)
    st = {}
    pr.seglayout_reference("B", (8, 128), pr.seglayout_inputs(), stats=st)
    assert set(st["nan_segments"].unique().tolist()) == {62}
    assert st["hits"][0] == 1024
    tab = pr.seglayout_inputs(P4_SEED)
    st = {}
    pr.seglayout_reference("A", (1, 1024), tab, stats=st)
    alive = pr.P4_SEGMENTS - st["nan_segments"]
    assert int(alive.max()) == 23 and float((alive >= 4).float().mean()) > 0.05
    k = pr._chain_consts("cpu")
    o = (torch.full((1024,), 0.1), torch.full((1024,), 0.2),
         torch.arange(1024).float() * k["lane"])
    d = (torch.ones(1024), torch.full((1024,), 0.5), torch.full((1024,), 0.25))
    tt = pr._sphere_tt(tuple(v[None] for v in o), tuple(v[None] for v in d),
                       tab["sc"][:, :4].T[:, :, None], k)
    st = {}
    pr.seglayout_reference("A", (1, 1024), pr.seglayout_inputs(
        pr.P4_SEED_LIVE), stats=st)
    assert not st["nan_segments"].any()      # every ray hits all along
    rows = pr.winner(tt)[1].unique().tolist()
    assert len(rows) >= 4 and 7 in rows      # row 7 ties with row 23
    mats = tab["smem"].view(pr.NA, pr.P4_ROW)[:, 5]
    assert len(mats.unique()) >= 5 and bool((mats == mats.round()).all())


@pytest.mark.parametrize("body,shape", [("A", (1, 1024)), ("B", (8, 128))])
def test_seglayout_special_tables_hold_every_special_discriminant(body,
                                                                  shape):
    """P4_SPECIAL: over four segments the discriminants include exact
    zeros (lanes 0, 3 and 17 of each sublane), subnormals (lane 0's, one
    each sign), negatives and NaN; -0 sits in the tables' centres and
    radii (a discriminant of -0 cannot arise). The output stays finite."""
    tab = pr.seglayout_inputs(pr.P4_SPECIAL)
    for t in (tab["sc"], tab["smem"]):
        assert bool(((t == 0) & torch.signbit(t)).any())
    st = {}
    out = pr.seglayout_reference(body, shape, tab, segments=4, stats=st)
    rows = shape[0]
    assert st["disc"]["zero"] == 3 * rows
    assert st["disc"]["neg_zero"] == 0
    assert st["disc"]["subnormal"] == 2 * rows
    assert st["disc"]["negative"] > 0 and st["disc"]["nan"] > 0
    assert bool(torch.isfinite(out).all())


@pytest.mark.parametrize("body,shape", [("A", (1, 1024)), ("B", (8, 128))])
def test_a_wrong_winner_changes_the_seeded_output(body, shape, monkeypatch):
    """The last of equal minima in place of the first changes the seeded
    output (its last row repeats row 7's sphere with another payload),
    and so does a winner one row off; at the probe's 24 identical rows
    neither shows."""
    tab, probe_tab = pr.seglayout_inputs(P4_SEED), pr.seglayout_inputs()
    right = pr.seglayout(body, shape, tab)
    right_probe = pr.seglayout(body, shape, probe_tab)
    first = pr.winner

    def last(tt):
        best, w = first(tt.flip(0))
        return best, torch.where(best < 3e38, tt.shape[0] - 1 - w, w)

    monkeypatch.setattr(pr, "winner", last)
    assert not torch.equal(pr.seglayout(body, shape, tab), right)
    monkeypatch.setattr(pr, "winner", lambda tt: (
        first(tt)[0], (first(tt)[1] + 1) % pr.NA))
    assert not torch.equal(pr.seglayout(body, shape, tab), right)
    if body == "A":
        assert torch.equal(pr.seglayout(body, shape, probe_tab), right_probe)


# --- P1 -------------------------------------------------------------------------

@pytest.fixture(scope="module")
def p1():
    return loader.load("probe_sublanes")


P1_CASES = [(s, seed) for s in pr.P1_SHAPES for seed in (None, P1_SEED)]


@pytest.mark.parametrize("shape,seed", P1_CASES, ids=[
    f"{s[0]}x{s[1]}-{'probe' if seed is None else 'seeded'}"
    for s, seed in P1_CASES])
def test_sublanes_twin_matches_the_jax_body(p1, shape, seed):
    x = pr.sublanes_inputs(shape, seed)
    want = np.asarray(p1["make"](shape)(x.numpy()))
    fused = pr.sublanes_reference(x, contract=True).numpy()
    assert _bits(fused, want)
    got = pr.sublanes(x).numpy()
    assert np.isfinite(got).all() and (got >= 0).all() and (got <= 2).all()
    if seed is None:
        assert _bits(got, want)


def test_sublanes_one_step_within_one_rounding():
    ns = loader.load("probe_sublanes", K=1)
    x = pr.sublanes_inputs((8, 128), P1_SEED)
    want = np.asarray(ns["make"]((8, 128))(x.numpy()))
    got = pr.sublanes_reference(x, iters=1).numpy()
    u = _ulps(got, want)
    # one rounding apart before the wrap at 2, where y < 4: 2^-22 at
    # most (y - 2 is exact, so the ulps after it can be many)
    diff = np.abs(got - want)
    assert diff.max() <= 2.0**-22 and (diff > 0).any()


# --- wrappers, counts, bounds ------------------------------------------------------

def test_wrappers_run_the_twins_on_the_cpu_and_check_their_input():
    names = ("packgrad", "packgrad2", "seglayout", "sublanes")
    before = [profiling.counter(f"launches.{n}") for n in names]
    assert torch.equal(pr.packgrad("B", "cpu", grid=7, bounces=2),
                       pr.packgrad_reference("B", "cpu", 2))
    pay = pr.packgrad2_inputs(1)
    assert torch.equal(pr.packgrad2("C", pay, grid=3, bounces=2),
                       pr.packgrad2_reference("C", pay, bounces=2))
    tab = pr.seglayout_inputs(2)
    assert torch.equal(pr.seglayout("B", (2, 64), tab, grid=5, segments=3),
                       pr.seglayout_reference("B", (2, 64), tab, 3))
    x = pr.sublanes_inputs((2, 8), 0)
    assert torch.equal(pr.sublanes(x, grid=2, iters=5),
                       pr.sublanes_reference(x, 5))
    # no kernel ran
    assert [profiling.counter(f"launches.{n}") for n in names] == before
    with pytest.raises(ValueError, match="unknown body"):
        pr.packgrad("C", "cpu")
    with pytest.raises(ValueError, match="float32"):
        pr.packgrad2("C", pay.double())
    with pytest.raises(ValueError, match="takes no input"):
        pr.packgrad2("D", pay)
    with pytest.raises(ValueError, match="shape"):
        pr.packgrad2("C", pay[:, :8].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        pr.sublanes(x.T)
    with pytest.raises(ValueError, match=r"\(1, TR\)"):
        pr.seglayout("A", (2, 64), tab)
    with pytest.raises(ValueError, match="grid"):
        pr.sublanes(x, grid=0)
    with pytest.raises(ValueError, match="no kernel information"):
        pr.kernel_info("seglayout", "A", "cpu")


def test_counts_and_bounds():
    """The bounds: counted operations over 67 TFLOP/s, every kernel's
    work far above its few KB of traffic."""
    ops, nbytes = pr.work("packgrad", "A", grid=pr.P2_GRID)
    assert ops == pr.P2_GRID * (32 * 256 * 16 * 34 + 7 * 24 * 16)
    assert nbytes == 24 * 128 * 4
    ops, nbytes = pr.work("seglayout", "B", (32, 256), grid=pr.P4_GRID)
    assert ops == pr.P4_GRID * 32 * 256 * (64 * 649 + 24)
    assert nbytes == 4 * 32 * 256 + 4 * 192
    ops, _ = pr.work("sublanes", "chain", (8, 128), grid=pr.P1_GRID)
    assert ops == 8 * 128 * 2000 * 512 * 4
    for probe, bodies in pr.BODIES.items():
        shape = {"seglayout": (8, 128), "sublanes": (1, 1024)}.get(probe)
        for body in bodies:
            ms, by = pr.bound(probe, body, shape, grid=4)
            assert by == "operations"
            assert ms == pytest.approx(
                pr.work(probe, body, shape, 4)[0] / sol.FP32_PEAK * 1e3)


def test_issue_and_shared_bounds():
    """The issue bound: 128 lanes a SM and clock; the shared-traffic
    bound: 128 bytes a SM and clock; P2 A's traffic: 24 rows of 16 floats
    read and written a warp and sublane step."""
    n = pr.element_bounces("seglayout", (1, 1024), grid=pr.P4_GRID)
    assert n == 1024 * 64 * 4096
    assert pr.element_bounces("packgrad") == 32 * 256 * 16
    # 1 980 element-bounces a lane of 132 SMs x 128 lanes, 1 000
    # instructions each: 1 980 000 clocks at 1 980 MHz
    assert pr.issue_bound_ms(1000, 132 * 128 * 1980, 132, 1980.0) == \
        pytest.approx(1.0)
    assert pr.shared_bytes() == 1024 * 8 * 16 * 32 * 24 * 16 * 4 * 2
    assert pr.shared_bound_ms(pr.shared_bytes(), 132, 1980.0) == \
        pytest.approx(0.3851, abs=1e-4)


def test_p3_gather_traffic_and_device_timing_need_a_card():
    """P3 C's gathers read 8 fields of 4 bytes an element-bounce: 1 GiB
    at the probe's GRID, 0.0321 ms of an H100's shared memory at 1 980
    MHz. Its kernel information is read off a card only."""
    assert pr.gather_bytes() == 512 * 16 * 256 * 16 * 8 * 4 == 2**30
    assert pr.gather_bytes(grid=1, bounces=2) == 16 * 256 * 2 * 32
    assert pr.shared_bound_ms(pr.gather_bytes(), 132, 1980.0) == \
        pytest.approx(0.0321, abs=1e-4)
    for body in pr.BODIES["packgrad2"]:
        with pytest.raises(ValueError, match="no kernel information"):
            pr.kernel_info("packgrad2", body, "cpu")


def test_chip_smoke_reads_slow_path_blocks_and_the_ptxas_log():
    """chip_smoke.py's readers: the instructions a predicated forward
    branch skips to reach a CALL are a slow-path block (run only when a
    lane needs it), and each kernel's registers and spills come off the
    `-Xptxas -v` log by name."""
    import importlib.util
    import os
    import re

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    listing = """
        /*0000*/                   MUFU.RSQ R7, R8 ;
        /*0010*/              @!P1 BRA 0x50 ;
        /*0020*/                   MOV R7, R8 ;
        /*0030*/                   CALL.REL.NOINC 0x90 ;
        /*0040*/                   BRA 0x60 ;
        /*0050*/                   FMUL.FTZ R1, R2, R3 ;
        /*0060*/                   BSYNC B0 ;
        /*0070*/               @P0 BRA 0x80 ;
        /*0080*/                   BRA 0x0 ;
    """
    ins = re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", listing)
    addrs = [int(a, 16) for a, _ in ins]
    opcodes = [re.sub(r"^@!?P\d+\s+", "", x.strip()).split()[0]
               .split(".")[0] for _, x in ins]
    assert cs.slow_call_blocks(ins, addrs, opcodes) == [0, 0, 1, 1, 1, 0, 0,
                                                        0, 0]
    log = """ptxas info    : Compiling entry function '_ZN3_GLOBAL__N_probe_seglayout_cu_ab13gather_kernelEPKf' for 'sm_90a'
    0 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 23 registers, used 1 barriers, 768 bytes smem
ptxas info    : Compiling entry function '_Z3fooPf' for 'sm_90a'
ptxas info    : Used 7 registers"""
    entries = cs.ptxas_entries(log)
    assert list(entries.values()) == [(23, 8, 12), (7, 0, 0)]
    assert [cs._probe_kernel(n) for n in entries] == [
        ("seglayout", "gather_kernel"), None]


# --- the entry-point scripts ---------------------------------------------------------

def _script(name):
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "scripts", f"torch_probe_{name}.py")
    spec = importlib.util.spec_from_file_location(f"torch_probe_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_script_packgrad_pure_functions():
    s = _script("packgrad")
    runs = {b: fn() for b, fn in s.cases("cpu", grid=2, bounces=1).items()}
    assert set(runs) == {"A", "B"}
    assert torch.equal(runs["A"], pr.packgrad_reference("A", "cpu", 1))
    assert s.line("A", 1.5) == ("A reshape+MXU scatter:     1.50 ms   "
                                "0.011 ns/lane-bounce")
    rec = s.record({"A": [2.0, 1.0], "B": [3.0]}, grid=2, bounces=1)
    assert rec["A_ms"] == 1.0 and rec["B_runs_ms"] == [3.0]
    assert rec["A_ns_per_lane_bounce"] == pytest.approx(1e6 / (2 * 8192))


def test_script_packgrad2_pure_functions():
    s = _script("packgrad2")
    runs = {b: fn() for b, fn in s.cases("cpu", grid=2, bounces=2).items()}
    assert torch.equal(runs["C"], torch.full(pr.P3_SHAPE, 16.0))
    assert torch.equal(runs["D"], pr.packgrad2_reference("D", bounces=2))
    assert s.line("D", 0.5).startswith("D scalar-sum table build           "
                                       ":     0.50 ms")
    rec = s.record({"C": [0.25], "D": [0.5]})
    assert rec["C_ns_per_lane_bounce"] == pytest.approx(
        0.25e6 / (512 * 16 * 4096))


def test_script_seglayout_pure_functions():
    s = _script("seglayout")
    cases = s.cases("cpu", grid=1, segments=2)
    assert list(cases) == [("A", sh) for sh in pr.P4_A_SHAPES] + [
        ("B", sh) for sh in pr.P4_B_SHAPES]
    out = cases["B", (8, 128)]()
    assert out.shape == (8, 128) and bool(torch.isfinite(out).all())
    assert s.line("A", (1, 1024), 10.0) == (
        "A (1,1024) mxu-gather       :    10.00 ms    0.037 ns/ray-seg  "
        "(26843.5 Mseg/s)")
    rec = s.record({("B", (8, 128)): [4.0, 2.0]})
    assert rec["B_8x128_ms"] == 2.0
    assert rec["B_8x128_mseg_s"] == pytest.approx(
        1024 * 64 * 4096 / 2e-3 / 1e6)


def test_script_sublanes_pure_functions():
    s = _script("sublanes")
    cases = s.cases("cpu", grid=1, iters=3, shapes=((2, 4),))
    x = pr.sublanes_inputs((2, 4))
    assert torch.equal(cases[2, 4](), pr.sublanes_reference(x, 3))
    assert s.line((8, 128), 0.2) == "(8, 128)    :     0.20 ms   " \
        "15.73 Tops/s"
    rec = s.record({(1, 8192): [1.0]})
    assert rec["1x8192_tops"] == pytest.approx(8192 * 2000 * 512 * 3 / 1e9)


def test_scripts_need_a_card_import_no_jax_and_write_no_cache():
    """Each scripts/torch_probe_*.py, with jax unimportable: main() exits
    with a message and prints nothing, and neither JAX nor the JAX
    package gets imported. The loader points no compilation cache into
    the repository."""
    import os
    import subprocess
    import sys

    import jax

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import importlib.util, sys, io, contextlib\n"
        "sys.modules['jax'] = None\n"
        "for name in ('packgrad', 'packgrad2', 'seglayout', 'sublanes'):\n"
        "    path = f'scripts/torch_probe_{name}.py'\n"
        "    spec = importlib.util.spec_from_file_location(name, path)\n"
        "    m = importlib.util.module_from_spec(spec)\n"
        "    spec.loader.exec_module(m)\n"
        "    out = io.StringIO()\n"
        "    try:\n"
        "        with contextlib.redirect_stdout(out):\n"
        "            m.main()\n"
        "    except SystemExit as e:\n"
        "        print(name, 'exit', 'is_available() is false' in str(e),\n"
        "              repr(out.getvalue()))\n"
        "bad = [k for k in sys.modules if k == 'tinyraytracer_tpu' or "
        "k.startswith(('tinyraytracer_tpu.', 'jax.', 'jaxlib'))]\n"
        "print('bad', bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.stdout.split("\n")[:5] == [
        f"{n} exit True ''" for n in ("packgrad", "packgrad2", "seglayout",
                                      "sublanes")] + ["bad []"], (
        proc.stdout, proc.stderr)
    loader.load("probe_sublanes")
    cache = jax.config.jax_compilation_cache_dir
    assert not (cache and os.path.abspath(cache).startswith(repo))
