"""The layout probes P1-P4 of scripts/ on the card: gradient scatter and
gather (P2 `probe_packgrad.py`, P3 `probe_packgrad2.py`), per-segment
layouts (P4 `probe_seglayout.py`) and block shapes (P1
`probe_sublanes.py`).

Each probe's bodies become one CUDA source (csrc/probe_packgrad.cu,
probe_packgrad2.cu, probe_seglayout.cu, probe_sublanes.cu) with a wrapper
here: `packgrad(body, ...)`, `packgrad2(body, ...)`, `seglayout(body,
...)`, `sublanes(x, ...)`. On a CUDA device a wrapper launches its kernel
and raises if the library does not build or the launch fails; on the CPU
it runs the plain twin (`*_reference`), which runs the kernel's
operations in the kernel's order, one torch op at a time, over one grid
step (the output does not depend on the grid). Each wrapper counts its
launches in the host counter `launches.<wrapper>` (`launches.packgrad`,
...; utils/profiling.py).

A grid step of the TPU becomes a CUDA block (or, for P4, the blocks of
one step's rays), all steps side by side, each storing the whole output
block (P3: only the last step stores it, as the TPU writes its one
output block back once): the kernel does the probe's GRID x block of
work, and GRID = 1 gives the same bits as the probe's GRID.

Inputs are made with numpy: the probe's own constants, or a seeded
variant that can show a wrong index (`packgrad2_inputs`,
`seglayout_inputs`, `sublanes_inputs`; P4 also has special-value
tables, `P4_SPECIAL`). `OPS_PER_ELEMENT` counts each kernel's FP32
operations in utils/sol.py's rule; `bound` turns them into the least
time the card could take. `issue_bound_ms` and `shared_bound_ms` give
the bounds of a kernel's issued instructions (read off its SASS) and of
shared-memory traffic (P2 A's scatter, `shared_bytes`; P3 C's gathers,
`gather_bytes`); `kernel_info` reads a P2, P3 or P4 kernel's blocks a SM
and registers off the card; `graph_ms` times a launch on the device
alone (a CUDA graph of wrapper calls).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tinyraytracer_tpu_torch import _build
from tinyraytracer_tpu_torch.ops.intersect import sqrt_rn
from tinyraytracer_tpu_torch.utils import profiling, sol
from tinyraytracer_tpu_torch.utils.device import resolve_device

# --- the probes' constants -----------------------------------------------------

NA = 24                       # table rows (spheres + quads)
TABLE = (NA, 128)             # P2's and P3 D's output block
# P2 (scripts/probe_packgrad.py:19-23)
P2_SHAPE, P2_K, P2_GRID, P2_BOUNCES = (32, 256), 16, 1024, 16
# P3 (scripts/probe_packgrad2.py:113-117)
P3_SHAPE, P3_F, P3_FIELDS, P3_P, P3_GRID, P3_BOUNCES = (16, 256), 32, 8, \
    4, 512, 16
# P4 (scripts/probe_seglayout.py:21-24, :153, :165)
P4_NM, P4_ROW, P4_PAY, P4_GRID, P4_SEGMENTS = 8, 8, 32, 4096, 64
P4_A_SHAPES = ((1, 1024), (1, 2048))
# Seeds of P4's tables (seglayout_inputs): rays that miss by their 23rd
# segment, and rays that hit in all 64 (no NaN state: the timing off the
# NaN path; their chain doubles an angle a segment, so they are held to
# the kernel, not to the JAX body's contracted arithmetic).
P4_SEED_SHORT, P4_SEED_LIVE = 5, 0
# P4's special-value tables (seglayout_inputs(P4_SPECIAL)): discriminants
# of exact zeros, subnormals, negatives and NaN; -0 in the tables.
P4_SPECIAL = "special"
P4_SEEDS = (P4_SEED_SHORT, P4_SEED_LIVE, P4_SPECIAL)   # besides the probe's
P4_B_SHAPES = ((8, 128), (8, 256), (8, 512), (16, 128), (16, 256), (32, 256))
# P1 (scripts/probe_sublanes.py:192-193, :221)
P1_ITERS, P1_GRID = 2000, 512
P1_SHAPES = ((1, 1024), (8, 128), (8, 1024), (16, 1024), (1, 8192))
P1_PROBE_OPS_PER_STEP = 3     # the probe's rate counts 3 a step

BODIES = {"packgrad": ("A", "B"), "packgrad2": ("C", "D"),
          "seglayout": ("A", "B"), "sublanes": ("chain",)}

# FP32 operations an element (lane, ray) and bounce (segment, step) of
# each kernel, read off csrc/probe_*.cu as it is built, in utils/sol.py's
# rule (an add, subtract, multiply, divide, compare, min/max or sqrt is
# one; a select, a load and integer arithmetic none). B's and D's
# `row == p` compares a float made from an integer with an integral
# constant: nvcc compares the integers (ISETP), so it is not counted.
OPS_PER_ELEMENT = {
    # c = (lane * 1e-3 + sub) + b: 2 (the multiply is loop-invariant);
    # 16 columns of c * (k + 1) added to the table: 32
    ("packgrad", "A"): 34,
    # c: 2; per row p: m * c, +, * 2 (an add), +: 4 x 24
    ("packgrad", "B"): 98,
    # 8 gathered fields added
    ("packgrad2", "C"): 8,
    # per p < 4: m * (lane + b), 3 multiples, 4 adds
    ("packgrad2", "D"): 32,
    # 24 sphere tests of 24 (3 sub, hb 5, c 6 without the invariant rad^2,
    # disc 2, max, sqrt, 2 roots, 3 compares, the running-minimum
    # compare); fixed_chain 61 (hash 24, two reciprocal roots of 8, the
    # unit vector 3, refl 5, the reflection 9, q's 3 products, att's
    # compare); best + nxw, att * alb, acc +, dx * 0.999: 4
    ("seglayout", "A"): 24 * 24 + 61 + 4,
    # A's plus the material gather's 8 compares
    ("seglayout", "B"): 24 * 24 + 61 + 4 + 8,
    # multiply, add, compare, subtract
    ("sublanes", "chain"): 4,
}
# P2 and P3 D's reductions at the end of a block, and P4's radius
# squares once a ray: operations a grid step besides OPS_PER_ELEMENT.
_WARPS = 8
OPS_PER_STEP = {
    ("packgrad", "A"): (_WARPS - 1) * NA * P2_K,
    ("packgrad", "B"): 2 * NA * (_WARPS * 5 + _WARPS - 1),
    ("packgrad2", "C"): 0,
    ("packgrad2", "D"): 4 * P3_P * (_WARPS * 5 + _WARPS - 1),
}


def _f(x, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def _raise(what, err):
    if err != 0:
        msg = _build.load().tinyrt_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _check_tensor(name, t, shape, device=None):
    if not isinstance(t, torch.Tensor) or t.dtype != torch.float32 \
            or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        got = (f"{t.dtype} {tuple(t.shape)}" if isinstance(t, torch.Tensor)
               else type(t).__name__)
        raise ValueError(f"{name} must be a contiguous float32 tensor of "
                         f"shape {tuple(shape)}, got {got}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, the launch on {device}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no probe kernel for device {t.device}")


def _check_counts(grid, bounces):
    if int(grid) < 1 or int(bounces) < 0 or grid >= 2**31:
        raise ValueError(f"grid={grid} must be >= 1 and bounces={bounces} "
                         ">= 0")


def _device(device):
    dev = resolve_device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no probe kernel for device {dev}")
    return dev


# --- P2: scatter (A) and masked sums (B) ---------------------------------------

def _lanes(device, shape):
    """Thread t is lane t: its index, lane * 1e-3 and its warp."""
    l = torch.arange(shape[1], device=device)
    return l, l.float() * _f(1e-3, device)


def _warp_tree(v: torch.Tensor) -> torch.Tensor:
    """Lane 0 of __shfl_down_sync's tree (offsets 16 .. 1) over dim 1 of
    (warps, 32, ...), then the warps added in order."""
    for half in (16, 8, 4, 2, 1):
        v = v[:, :half] + v[:, half:2 * half]
    out = v[0, 0]
    for w in range(1, v.shape[0]):
        out = out + v[w, 0]
    return out


def _scatter_reference(device, bounces, turns=False):
    s_n, width = P2_SHAPE
    l, lf = _lanes(device, P2_SHAPE)
    kf = torch.arange(1, P2_K + 1, device=device).float()
    slots = (width // 32) * NA
    tab = torch.zeros(slots, P2_K, device=device)
    lower = torch.ones(32, 32, dtype=torch.bool, device=device).tril(-1)
    groups = []     # per sublane and rank t: (warp, row) slots, their
    for s in range(s_n):    # lanes, their writer's place among rank 0's
        row = (l + s) % NA
        rw = row.view(-1, 32)
        rank = ((rw[:, :, None] == rw[:, None, :]) & lower).sum(-1).view(-1)
        slot = (l // 32) * NA + row
        at = torch.zeros(slots, dtype=torch.long, device=device)
        at[slot[rank == 0]] = torch.arange(int((rank == 0).sum()),
                                           device=device)
        groups.append([(slot[rank == t], lf[rank == t], at[slot[rank == t]])
                       for t in range(int(rank.max()) + 1)])
    for b in range(bounces):
        for s in range(s_n):
            if turns:
                for slot, lft, _ in groups[s]:
                    c = (lft + float(s)) + float(b)
                    tab.index_copy_(0, slot, tab.index_select(0, slot)
                                    + c[:, None] * kf)
                continue
            (slot, lft, _), *rest = groups[s]
            add = ((lft + float(s)) + float(b))[:, None] * kf
            for _, lft, at in rest:
                c = (lft + float(s)) + float(b)
                add.index_copy_(0, at, add.index_select(0, at)
                                + c[:, None] * kf)
            tab.index_copy_(0, slot, tab.index_select(0, slot) + add)
    tab = tab.view(width // 32, NA, P2_K)
    v = tab[0]
    for u in range(1, tab.shape[0]):
        v = v + tab[u]
    out = torch.zeros(TABLE, device=device)
    out[:, :P2_K] = v
    return out


def _masked_reference(device, bounces):
    s_n, width = P2_SHAPE
    l, lf = _lanes(device, P2_SHAPE)
    pf = torch.arange(NA, device=device).float()
    acc = torch.zeros(width, 2 * NA, device=device)
    for b in range(bounces):
        for s in range(s_n):
            c = (lf + float(s)) + float(b)
            rowf = ((l + s) % NA).float()
            mc = (rowf[:, None] == pf).float() * c[:, None]
            acc[:, 0::2] = acc[:, 0::2] + mc
            acc[:, 1::2] = acc[:, 1::2] + mc * 2.0
    out = torch.zeros(TABLE, device=device)
    out[0, :2 * NA] = _warp_tree(acc.view(width // 32, 32, 2 * NA))
    return out


def packgrad_reference(body: str, device="cpu", bounces: int = P2_BOUNCES,
                       turns: bool = False) -> torch.Tensor:
    """The (24, 128) block of body A (scatter) or B (masked sums) of
    scripts/probe_packgrad.py after `bounces` bounces, in the kernel's
    order (bit for bit with it): in A, the lanes of a warp that share a
    row add their values in lane order, then the sum goes into the row.
    With `turns` (A only), they add into the row one after another, an
    order the kernel does not run: its sums differ from the kernel's by
    rounding alone."""
    if body not in BODIES["packgrad"]:
        raise ValueError(f"unknown body {body!r}: A or B")
    if turns and body != "A":
        raise ValueError("turns is an order of body A")
    _check_counts(1, bounces)
    dev = _device(device)
    if body == "B":
        return _masked_reference(dev, bounces)
    return _scatter_reference(dev, bounces, turns)


def packgrad(body: str, device="cuda", grid: int = P2_GRID,
             bounces: int = P2_BOUNCES) -> torch.Tensor:
    """Body A or B of P2 over `grid` grid steps: csrc/probe_packgrad.cu
    on a CUDA device, the twin on the CPU. Does not synchronise."""
    if body not in BODIES["packgrad"]:
        raise ValueError(f"unknown body {body!r}: A or B")
    _check_counts(grid, bounces)
    dev = _device(device)
    if dev.type == "cpu":
        return packgrad_reference(body, dev, bounces)
    out = torch.empty(TABLE, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        err = lib.tinyrt_probe_packgrad(out.data_ptr(), "AB".index(body),
                                        int(grid), int(bounces), _stream(dev))
    _raise("probe_packgrad", err)
    profiling.count("launches.packgrad")
    return out



# --- P3: gather (C) and scalar-sum table (D) ----------------------------------

def packgrad2_inputs(seed=None, device="cpu") -> torch.Tensor:
    """C's `pay` (32, 24): the probe's ones, or uniform in [0.25, 4) from
    `seed` (every column differs, so a wrong gather index shows)."""
    if seed is None:
        pay = np.ones((P3_F, NA), np.float32)
    else:
        rng = np.random.default_rng(seed)
        pay = (0.25 + 3.75 * rng.random((P3_F, NA))).astype(np.float32)
    return torch.from_numpy(pay).to(device)


def gather_index(rows: torch.Tensor, b: int) -> torch.Tensor:
    """C's column of bounce b: (row + b) mod 24."""
    return (rows + b) % NA


def _gather_reference(pay, bounces):
    s_n, width = P3_SHAPE
    dev = pay.device
    rows = (torch.arange(width, device=dev)[None]
            + torch.arange(s_n, device=dev)[:, None]) % NA
    acc = torch.zeros(P3_SHAPE, device=dev)
    for b in range(bounces):
        col = gather_index(rows, b)
        tot = acc
        for i in range(P3_FIELDS):
            tot = tot + pay[i][col]
        acc = tot
    return acc


def _table_reference(device, bounces):
    s_n, width = P3_SHAPE
    l = torch.arange(width, device=device)
    lf = l.float()
    pf = torch.arange(P3_P, device=device).float()
    mult = torch.arange(1, 5, device=device).float()
    acc = torch.zeros(width, P3_P, 4, device=device)
    for b in range(bounces):
        lb = lf + float(b)
        for s in range(s_n):
            rowf = ((l + s) % NA).float()
            c = (rowf[:, None] == pf).float() * lb[:, None]
            acc = acc + c[:, :, None] * mult
    out = torch.zeros(TABLE, device=device)
    out[:P3_P, :4] = _warp_tree(acc.view(width // 32, 32, P3_P, 4))
    return out


def packgrad2_reference(body: str, pay=None, device="cpu",
                        bounces: int = P3_BOUNCES) -> torch.Tensor:
    """Body C (the (16, 256) gather from `pay`) or D (the (24, 128)
    table; no input) of scripts/probe_packgrad2.py after `bounces`
    bounces, bit for bit with the kernel and the JAX body: C in the
    kernel's order; D's integer sums are exact in any order (the kernel
    runs its sublanes outside its bounces, this twin inside)."""
    _check_counts(1, bounces)
    if body == "C":
        _check_tensor("pay", pay, (P3_F, NA))
        return _gather_reference(pay, bounces)
    if body == "D":
        return _table_reference(_device(device), bounces)
    raise ValueError(f"unknown body {body!r}: C or D")


def packgrad2(body: str, pay=None, device="cuda", grid: int = P3_GRID,
              bounces: int = P3_BOUNCES) -> torch.Tensor:
    """Body C (on `pay`'s device) or D (on `device`) of P3 over `grid`
    grid steps: csrc/probe_packgrad2.cu on a CUDA device, the twin on the
    CPU. Does not synchronise."""
    _check_counts(grid, bounces)
    if body == "C":
        _check_tensor("pay", pay, (P3_F, NA))
        dev = pay.device
    elif body == "D":
        if pay is not None:
            raise ValueError("body D takes no input")
        dev = _device(device)
    else:
        raise ValueError(f"unknown body {body!r}: C or D")
    if dev.type == "cpu":
        return packgrad2_reference(body, pay, dev, bounces)
    out = torch.empty(P3_SHAPE if body == "C" else TABLE, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        err = lib.tinyrt_probe_packgrad2(
            pay.data_ptr() if body == "C" else None, out.data_ptr(),
            "CD".index(body), int(grid), int(bounces), _stream(dev))
    _raise("probe_packgrad2", err)
    profiling.count("launches.packgrad2")
    return out



# --- P4: per-segment layouts, A (gather) and B (scalars, selects) --------------

def seglayout_inputs(seed=None, device="cpu") -> dict:
    """P4's tables: `sc` (24, 8) and `pay` (32, 24) for A, `smem` (1, 192)
    for B. With no seed, the probe's own (every entry 0.5, 0.25, 0.5:
    24 identical spheres). With a seed: 22 small spheres on the first
    segment's rays (centres (0.1, 0.2, z) + t (1, 0.5, 0.25), z in [0, 1),
    t in [0.3, 1)), so the winner varies from ray to ray, and 2 larger
    ones scattered about 6 (1, 0.5, 0.25), which some rays keep hitting
    for several segments while the rest miss and turn NaN; the last row
    repeats row 7's sphere with its own payload, so the first of equal
    minima must win (jnp.argmin); A's payload
    and B's nxw uniform in [0, 0.5), albedos in [0.1, 1); B's material
    ids the integers 0-7 at smem[p * 8 + 5], its albedo of material m at
    smem[m * 8 + 6]. With seed P4_SPECIAL: P4_SEED_SHORT's tables with
    rows 1-6 made special for the first segment's rays (`_special_rows`).
    """
    if seed == P4_SPECIAL:
        tab = {k: v.numpy()
               for k, v in seglayout_inputs(P4_SEED_SHORT).items()}
        rows = _special_rows()
        tab["sc"][1:1 + len(rows), :4] = rows
        smem = tab["smem"].reshape(NA, P4_ROW)
        smem[1:1 + len(rows), :4] = rows
        return {k: torch.from_numpy(v).to(device) for k, v in tab.items()}
    if seed is None:
        sc = np.full((NA, P4_ROW), 0.5, np.float32)
        pay = np.full((P4_PAY, NA), 0.25, np.float32)
        smem = np.full((1, NA * P4_ROW), 0.5, np.float32)
    else:
        rng = np.random.default_rng(seed)
        d = np.array([1.0, 0.5, 0.25])
        z, t = rng.uniform(0.0, 1.0, NA), rng.uniform(0.3, 1.0, NA)
        cen = np.array([0.1, 0.2, 0.0]) + t[:, None] * d
        cen[:, 2] += z
        cen[:2] = 6.0 * d + rng.normal(0.0, 3.0, (2, 3))
        rad = rng.uniform(0.05, 0.2, NA)
        rad[:2] = rng.uniform(0.2, 0.4, 2)
        cen[-1], rad[-1] = cen[7], rad[7]    # a tie: the first row wins
        sc = rng.uniform(0.0, 1.0, (NA, P4_ROW))
        sc[:, :3], sc[:, 3] = cen, rad
        pay = rng.uniform(0.1, 1.0, (P4_PAY, NA))
        pay[0] = rng.uniform(0.0, 0.5, NA)
        rows = rng.uniform(0.0, 1.0, (NA, P4_ROW))
        rows[:, :4] = sc[:, :4]
        rows[:, 4] = rng.uniform(0.0, 0.5, NA)
        rows[:, 5] = rng.integers(0, P4_NM, NA)
        rows[:, 6] = rng.uniform(0.1, 1.0, NA)
        sc, pay = sc.astype(np.float32), pay.astype(np.float32)
        smem = rows.astype(np.float32).reshape(1, -1)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in (("sc", sc), ("pay", pay), ("smem", smem))}


def _special_rows() -> np.ndarray:
    """(cx, cy, cz, rad) of six spheres whose discriminants hb^2 - c on
    the first segment's rays (origin (0.1, 0.2, lane * 1e-3), direction
    (1, 0.5, 0.25)) are special:
    - a NaN centre: disc NaN on every ray and segment;
    - centre z = -1e-20 beside lane 0's origin, radius 1.1e-20: a
      positive subnormal disc on lane 0 (hb^2 and c subnormal too);
    - the same centre, radius 0: a negative subnormal disc on lane 0;
    - lane 0's origin with z = -0 and radius -0: disc = +0 exactly (m
      = 0 - (-0) = +0);
    - lanes 3's and 17's origins, radius 0: disc = +0 exactly there.
    A disc of -0 cannot arise: hb * hb - c is +0 whenever both are zero,
    since a square is never -0 and c = |m|^2 - rad^2 is +0 then; the -0s
    of these rows enter its operands. Every other lane of these rows has
    a negative disc."""
    lane = np.float32(1e-3)
    z = [np.float32(3) * lane, np.float32(17) * lane]
    return np.array([[np.nan, 0.2, 0.0, 0.1],
                     [0.1, 0.2, -1e-20, 1.1e-20],
                     [0.1, 0.2, -1e-20, 0.0],
                     [0.1, 0.2, -0.0, -0.0],
                     [0.1, 0.2, z[0], 0.0],
                     [0.1, 0.2, z[1], 0.0]], np.float32)


def _disc_kinds(disc: torch.Tensor) -> dict:
    """Counts of special discriminants: +0, -0, subnormal (nonzero, below
    2^-126 in magnitude), negative (any < 0) and NaN."""
    zero = disc == 0
    return {"zero": int((zero & ~torch.signbit(disc)).sum()),
            "neg_zero": int((zero & torch.signbit(disc)).sum()),
            "subnormal": int((~zero & (disc.abs() < 2.0**-126)).sum()),
            "negative": int((disc < 0).sum()),
            "nan": int(torch.isnan(disc).sum())}


def _max_nan(a, b):
    return torch.maximum(a, b)      # NaN in, NaN out, as jnp.maximum


def _sphere_tt(o, d, rows, k, kinds=None):
    ox, oy, oz = o
    dx, dy, dz = d
    cx, cy, cz, rad = rows
    mx, my, mz = ox - cx, oy - cy, oz - cz
    hb = (mx * dx + my * dy) + mz * dz
    c = ((mx * mx + my * my) + mz * mz) - rad * rad
    disc = hb * hb - c
    if kinds is not None:
        for key, n in _disc_kinds(disc).items():
            kinds[key] = kinds.get(key, 0) + n
    sq = sqrt_rn(_max_nan(disc, k["zero"]))
    t0 = -hb - sq
    t1 = -hb + sq
    tt = torch.where(t0 > k["eps"], t0, t1)
    return torch.where((disc > k["zero"]) & (tt > k["eps"]), tt, k["miss"])


def fixed_chain(o, d, u, k):
    """scripts/probe_seglayout.py:27 op by op; `k` the f32 constants
    (the hash's as JAX rounds them). Returns (o', att)."""
    ox, oy, oz = o
    dx, dy, dz = d
    h = u
    for _ in range(6):
        h = h * k["m"] + k["a"]
        h = torch.where(h > k["e9"], h * k["em9"], h)
    r = 1.0 / sqrt_rn(_max_nan((ox * ox + oy * oy) + oz * oz, k["tiny"]))
    sx, sy, sz = ox * r, oy * r, oz * r
    refl = (dx * sx + dy * sy) + dz * sz
    r2 = 2.0 * refl
    nx = (dx - r2 * sx) + h * k["em10"]
    ny = dy - r2 * sy
    nz = dz - r2 * sz
    q = 1.0 / sqrt_rn(_max_nan((nx * nx + ny * ny) + nz * nz, k["tiny"]))
    att = torch.where(refl > 0.0, k["half"], k["att"])
    return (nx * q, ny * q, nz * q), att


def _chain_consts(device):
    return {n: _f(v, device) for n, v in (
        ("m", 747796405.0), ("a", 2891336453.0), ("e9", 1e9), ("em9", 1e-9),
        ("tiny", 1e-9), ("em10", 1e-10), ("half", 0.5), ("att", 0.9),
        ("shrink", 0.999), ("lane", 1e-3), ("zero", 0.0), ("eps", 1e-3),
        ("miss", 3e38))}


def winner(tt: torch.Tensor) -> tuple:
    """The first minimum over dim 0 of the (24, n) distances: (best,
    row), a strict-< fold from 3e38 as the kernels run it (row 0 when
    every test misses, as jnp.argmin)."""
    best = torch.full_like(tt[0], 3e38)
    w = torch.zeros(tt.shape[1:], dtype=torch.long, device=tt.device)
    for p in range(tt.shape[0]):
        hit = tt[p] < best
        best = torch.where(hit, tt[p], best)
        w = torch.where(hit, p, w)
    return best, w


def _seg_tables(body, tables):
    """Checks body's tables; returns their device."""
    if body not in BODIES["seglayout"]:
        raise ValueError(f"unknown body {body!r}: A or B")
    if body == "A":
        sc, pay = tables["sc"], tables["pay"]
        _check_tensor("sc", sc, (NA, P4_ROW))
        _check_tensor("pay", pay, (P4_PAY, NA), sc.device)
        return sc.device
    smem = tables["smem"]
    _check_tensor("smem", smem, (1, NA * P4_ROW))
    return smem.device


def seglayout_reference(body: str, shape, tables: dict,
                        segments: int = P4_SEGMENTS, stats=None):
    """Body A ((1, TR) rays, `tables` sc and pay) or B ((S, L), smem) of
    scripts/probe_seglayout.py after `segments` segments, in the kernel's
    order (bit for bit with it). With a dict `stats`, fills
    `nan_segments`: per ray, the segments that start on a NaN origin,
    `hits`: per segment, the rays with a hit, and `disc`: the special
    discriminants of every row, ray and segment (`_disc_kinds`)."""
    _check_counts(1, segments)
    dev = _seg_tables(body, tables)
    s_n, width = shape
    if body == "A":
        pay = tables["pay"]
        rows = tables["sc"][:, :4].T[:, :, None]   # (4, 24, 1)
    else:
        smem = tables["smem"]
        rows = smem.view(NA, P4_ROW)[:, :4].T[:, :, None]
    k = _chain_consts(dev)
    lanes = torch.arange(width, device=dev).float() * k["lane"]
    oz = lanes.expand(s_n, width).reshape(-1)
    n = oz.numel()
    o = (torch.full((n,), 0.1, device=dev), torch.full((n,), 0.2, device=dev),
         oz.clone())
    dx = torch.ones(n, device=dev)
    dy, dz = torch.full_like(dx, 0.5), torch.full_like(dx, 0.25)
    acc = torch.zeros(n, device=dev)
    nan_segs = torch.zeros(n, dtype=torch.long, device=dev)
    hits, kinds = [], ({} if stats is not None else None)
    for _ in range(segments):
        if stats is not None:
            nan_segs += (torch.isnan(o[0]) | torch.isnan(o[1])
                         | torch.isnan(o[2]))
        tt = _sphere_tt(tuple(v[None] for v in o),
                        (dx[None], dy[None], dz[None]), rows, k, kinds)
        best, w = winner(tt)
        if stats is not None:
            hits.append(int((best < k["miss"]).sum()))
        if body == "A":
            nxw, alb = pay[0][w], pay[1][w]
        else:
            tab = smem.view(NA, P4_ROW)
            nxw, mat = tab[w, 4], tab[w, 5]
            hit = best < k["miss"]
            nxw = torch.where(hit, nxw, k["zero"])
            mat = torch.where(hit, mat, k["zero"])
            alb = torch.zeros_like(acc)
            for m in range(P4_NM):
                alb = torch.where(mat == float(m), tab[m, 6], alb)
        o, att = fixed_chain(o, (dx, dy, dz), best + nxw, k)
        acc = acc + att * alb
        dx = dx * k["shrink"]
    if stats is not None:
        stats["nan_segments"] = nan_segs.view(s_n, width)
        stats["hits"] = hits
        stats["disc"] = kinds
    return acc.view(s_n, width)


def seglayout(body: str, shape, tables: dict, grid: int = P4_GRID,
              segments: int = P4_SEGMENTS) -> torch.Tensor:
    """Body A (shape (1, TR); tables sc, pay) or B (shape (S, L); table
    smem, its values passed by value in the launch) of P4 over `grid`
    grid steps: csrc/probe_seglayout.cu on a CUDA device, the twin on
    the CPU. Does not synchronise."""
    _check_counts(grid, segments)
    shape = tuple(int(v) for v in shape)
    if len(shape) != 2 or min(shape) < 1 or (body == "A" and shape[0] != 1):
        raise ValueError(f"shape {shape}: (1, TR) for A, (S, L) for B")
    dev = _seg_tables(body, tables)
    if dev.type == "cpu":
        return seglayout_reference(body, shape, tables, segments)
    out = torch.empty(shape, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        if body == "A":
            err = lib.tinyrt_probe_seglayout_a(
                tables["sc"].data_ptr(), tables["pay"].data_ptr(),
                out.data_ptr(), shape[1], int(grid), int(segments),
                _stream(dev))
        else:
            host = tables["smem"].cpu().numpy()
            err = lib.tinyrt_probe_seglayout_b(
                host.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                out.data_ptr(), out.numel(), shape[1], int(grid),
                int(segments), _stream(dev))
    _raise("probe_seglayout", err)
    profiling.count("launches.seglayout")
    return out



# --- P1: block shapes ----------------------------------------------------------

def sublanes_inputs(shape, seed=None, device="cpu") -> torch.Tensor:
    """P1's x: the probe's 0.5 everywhere, or uniform in [0.25, 1.75)
    from `seed`."""
    if seed is None:
        x = np.full(shape, 0.5, np.float32)
    else:
        x = np.random.default_rng(seed).uniform(0.25, 1.75, shape)
    return torch.from_numpy(x.astype(np.float32)).to(device)


def sublanes_reference(x: torch.Tensor, iters: int = P1_ITERS,
                       contract: bool = False):
    """The probe's chain on every element of x, op by op: the kernel's
    bits. With `contract`, y * 1.000001 + x rounds once (formed in f64
    from the exact product), as XLA contracts it into a fused
    multiply-add on the CPU: the JAX body's bits."""
    _check_tensor("x", x, x.shape)
    _check_counts(1, iters)
    a, two = _f(1.000001, x.device), _f(2.0, x.device)
    a64, x64 = a.double(), x.double()
    y = x
    for _ in range(iters):
        y = (y.double() * a64 + x64).float() if contract else y * a + x
        y = torch.where(y > two, y - two, y)
    return y


def sublanes(x: torch.Tensor, grid: int = P1_GRID,
             iters: int = P1_ITERS) -> torch.Tensor:
    """P1's chain over `grid` grid steps of the block x (2-D float32):
    csrc/probe_sublanes.cu on a CUDA tensor, the twin on a CPU tensor.
    Does not synchronise."""
    _check_tensor("x", x, x.shape)
    _check_counts(grid, iters)
    if x.dim() != 2 or x.numel() < 1 or x.numel() >= 2**31:
        raise ValueError(f"x must be a non-empty 2-D block, got "
                         f"{tuple(x.shape)}")
    if x.device.type == "cpu":
        return sublanes_reference(x, iters)
    out = torch.empty_like(x)
    lib = _build.load()
    with torch.cuda.device(x.device):
        err = lib.tinyrt_probe_sublanes(x.data_ptr(), out.data_ptr(),
                                        x.numel(), int(grid), int(iters),
                                        _stream(x.device))
    _raise("probe_sublanes", err)
    profiling.count("launches.sublanes")
    return out



# --- counts, bounds, timing ----------------------------------------------------

def _block(probe, shape, bounces):
    """(elements of a grid step's block, bounces) with the defaults."""
    shape = {"packgrad": P2_SHAPE, "packgrad2": P3_SHAPE}.get(probe, shape)
    if bounces is None:
        bounces = {"packgrad": P2_BOUNCES, "packgrad2": P3_BOUNCES,
                   "seglayout": P4_SEGMENTS, "sublanes": P1_ITERS}[probe]
    return int(shape[0]) * int(shape[1]), int(bounces)


def element_bounces(probe: str, shape=None, grid: int = 1,
                    bounces: int = None) -> int:
    """Element-bounces (lane-bounces, ray-segments, element-steps) of one
    launch over `grid` steps."""
    n, bounces = _block(probe, shape, bounces)
    return n * bounces * grid


def work(probe: str, body: str, shape=None, grid: int = 1,
         bounces: int = None) -> tuple:
    """(FP32 operations, bytes) of one launch over `grid` steps: the
    operations counted off the source; each input read once and the
    output block written once."""
    n, bounces = _block(probe, shape, bounces)
    ops = n * bounces * OPS_PER_ELEMENT[probe, body]
    if probe in ("packgrad", "packgrad2"):
        ops += OPS_PER_STEP[probe, body]
        if (probe, body) == ("packgrad2", "D"):
            ops += P3_SHAPE[1] * bounces            # lane + b
        out = P3_SHAPE if (probe, body) == ("packgrad2", "C") else TABLE
        nbytes = 4 * out[0] * out[1] + (4 * P3_F * NA if body == "C" else 0)
    elif probe == "seglayout":
        ops += n * NA                               # rad * rad once a ray
        nbytes = 4 * n + (4 * (NA * P4_ROW + P4_PAY * NA) if body == "A"
                          else 4 * NA * P4_ROW)
    else:
        nbytes = 8 * n
    return ops * grid, nbytes


def bound(probe: str, body: str, shape=None, grid: int = 1,
          bounces: int = None) -> tuple:
    """(ms, "operations" or "bytes"): the least time the card could take
    for one launch, utils/sol.py's roofline of `work`."""
    return sol.probe_bound(*work(probe, body, shape, grid, bounces))


# Per SM and clock on the card: 4 schedulers issue a warp instruction
# each (128 lanes), and shared memory moves 128 bytes.
LANES_PER_SM_CLOCK = 128
SHARED_BYTES_PER_SM_CLOCK = 128


def shared_bytes(grid: int = P2_GRID, bounces: int = P2_BOUNCES) -> int:
    """Shared-memory bytes P2 A's scatter must move over `grid` steps: a
    warp and sublane step reads and writes each row its lanes reach (24:
    32 consecutive lanes, rows mod 24), 16 floats each."""
    s_n, width = P2_SHAPE
    return grid * (width // 32) * bounces * s_n * NA * P2_K * 4 * 2


def gather_bytes(grid: int = P3_GRID, bounces: int = P3_BOUNCES) -> int:
    """Shared-memory bytes P3 C's gathers read over `grid` steps: each
    element and bounce its 8 fields, 4 bytes each, by a lane's own load.
    A warp's 32 lanes reach only 24 columns, but its loads still take 8
    wavefronts of 128 bytes: one a 4-byte load, four a 16-byte one."""
    return element_bounces("packgrad2", None, grid, bounces) * P3_FIELDS * 4


def issue_bound_ms(instructions: float, elements: int, sms: int,
                   clock_mhz: float) -> float:
    """The least time `elements` element-bounces take when each issues
    `instructions` SASS instructions: 128 lanes a SM and clock."""
    return (instructions * elements / (LANES_PER_SM_CLOCK * sms
                                       * clock_mhz * 1e6) * 1e3)


def shared_bound_ms(nbytes: int, sms: int, clock_mhz: float) -> float:
    """The least time shared memory takes to move `nbytes`: 128 bytes a
    SM and clock."""
    return nbytes / (SHARED_BYTES_PER_SM_CLOCK * sms * clock_mhz * 1e6) * 1e3


def kernel_info(probe: str, body: str, device="cuda") -> dict:
    """P2's, P3's or P4's kernel for `body` as the card runs it: its
    resident blocks of 256 a SM and its registers a thread. Raises off a
    card."""
    dev = _device(device)
    if dev.type != "cuda" or probe not in ("packgrad", "packgrad2",
                                           "seglayout"):
        raise ValueError(f"no kernel information for {probe} on {dev}")
    info = (ctypes.c_int * 2)()
    lib = _build.load()
    with torch.cuda.device(dev):
        err = getattr(lib, f"tinyrt_probe_{probe}_info")(
            BODIES[probe].index(body), info)
    _raise(f"probe_{probe} info", err)
    return {"blocks_per_sm": info[0], "registers": info[1]}


def launch_ms(fn) -> tuple:
    """(result, ms by CUDA events) of one launch, synchronised."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def graph_ms(fn, launches: int = 20, replays: int = 5) -> float:
    """Device ms a launch of `fn` (a wrapper call): `launches` calls
    captured in one CUDA graph, replayed `replays` times between CUDA
    events, the best replay over `launches`. No host work between the
    kernels, so a kernel shorter than its wrapper's host path is timed,
    not the host. The calls in the capture add to the wrapper's launch
    count; the replays do not."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        fn()
        torch.cuda.synchronize()
        with torch.cuda.graph(graph, stream=side):
            for _ in range(launches):
                fn()
    torch.cuda.synchronize()
    return min(launch_ms(graph.replay)[1] / launches for _ in range(replays))


def best_ms(fn, runs: int) -> tuple:
    """The probe's timing: one warm-up, then the best of `runs` launches
    (CUDA events around each). Returns (ms, every run's ms, result)."""
    fn()
    torch.cuda.synchronize()
    times, out = [], None
    for _ in range(runs):
        out, ms = launch_ms(fn)
        times.append(ms)
    return min(times), times, out
