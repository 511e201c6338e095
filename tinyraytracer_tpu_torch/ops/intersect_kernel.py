"""Closest-hit selection over a compacted scene: kernel K3 and its twin.

Port of the JAX package's ops/intersect_pallas.py (`_closest_hit_kernel`,
intersect_pallas.py:166, launched by `closest_hit_pallas`). For a batch of
rays it returns the detached selection (t, j): the screening t and the
winner's global primitive id (spheres then quads; -1 = miss), the first
row at the minimum over spheres then quads. Selection is detached by
design: the winner's t is recomputed differentiably by
`intersect.prim_t`, so gradients are the same whichever selection ran.

`closest_hit` is the wrapper. On a CPU tensor it runs
`closest_hit_reference`, the plain PyTorch twin, which follows the Pallas
kernel's own formulas (intersect_pallas.py:185-241); on a CUDA tensor it
launches csrc/closest_hit.cu, built at first use, and raises if the launch
fails. `closest_hit.launches` counts kernel launches. `need_j=False` (a
shadow ray's occluder test) returns only t: the kernel then tracks and
stores no winner.

`compact_rows` lowers a scene's valid primitives (scene_table.compact_scene,
bitwise equal to the JAX package's) into the rows the kernel reads: device
tensors, and for a scene of at most BANK_MAX_ROWS real rows also their
packed bytes (`pack_bank`), which the kernel takes by value in its
parameters (the bank route; larger scenes take the global route).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from tinyraytracer_tpu_torch import _build
from tinyraytracer_tpu_torch.ops import scene_table
from tinyraytracer_tpu_torch.ops.intersect import (
    MISS_T,
    T_MIN,
    HitRecord,
    select_to_record,
)

# Most elements of one twin candidate matrix (rows x rays); rays go in
# chunks above it, which changes no bit.
CANDIDATE_BUDGET = 1 << 24
# Real rows (spheres + quads) a scene may have to take the bank route, and
# the bytes of its packed rows (csrc/closest_hit.cu kBankRows, BankRows):
# sphere k (c, r^2) at float4 k, quad k (n, dp | av, ca | bv, cb) at
# float4s BANK_MAX_ROWS + 3k..3k+2, then the global ids, i32: sphere k's
# at k, quad k's at BANK_MAX_ROWS + k.
BANK_MAX_ROWS = 48
BANK_BYTES = 4 * (4 * BANK_MAX_ROWS + 12 * BANK_MAX_ROWS + 2 * BANK_MAX_ROWS)


@dataclasses.dataclass(frozen=True)
class CompactRows:
    """A compacted scene on a device, as K3 reads it.

    `sph` (ns, 4): cx cy cz r^2; `quad` (nq, 12): n, n.corner, av, ca, bv,
    cb; both padded to multiples of 8 with inert rows, real rows first.
    `index_map` (ns + nq,) i32 sends a compacted row to its global id.
    `bank`: the real rows packed for the kernel's parameters (`pack_bank`),
    or None for the global route. `plain` selects with the twin even on
    the card (to hold K3 to it).
    """

    sph: torch.Tensor
    quad: torch.Tensor
    index_map: torch.Tensor
    n_sph: int
    n_quad: int
    plain: bool = False
    bank: Optional[bytes] = None

    @property
    def ns(self) -> int:
        return int(self.sph.shape[0])

    @property
    def route(self) -> str:
        """The kernel's route: "bank" (rows in its parameters) or
        "global" (rows read from `sph` and `quad`)."""
        return "global" if self.bank is None else "bank"


def compact_rows(scene, device, plain: bool = False) -> CompactRows:
    """Host compaction of `scene` (valid primitives only, quad planes
    precomputed) copied to `device`; the bank bytes packed from the same
    host arrays when the real rows fit BANK_MAX_ROWS."""
    cs = scene_table.compact_scene(scene)
    dev = torch.device(device)
    sph = np.ascontiguousarray(np.concatenate([cs.sph_c, cs.sph_r2], 1),
                               np.float32)
    quad = np.ascontiguousarray(np.concatenate(
        [cs.quad_n, cs.quad_dp, cs.quad_av, cs.quad_ca, cs.quad_bv,
         cs.quad_cb], 1), np.float32)
    n_sph, n_quad = cs.n_sph_real, cs.n_quad_real
    bank = None
    if n_sph + n_quad <= BANK_MAX_ROWS:
        bank = pack_bank(sph[:n_sph], quad[:n_quad],
                         cs.index_map[:n_sph],
                         cs.index_map[cs.ns:cs.ns + n_quad])
    return CompactRows(sph=torch.from_numpy(sph).to(dev),
                       quad=torch.from_numpy(quad).to(dev),
                       index_map=torch.from_numpy(cs.index_map).to(dev),
                       n_sph=n_sph, n_quad=n_quad, plain=plain, bank=bank)


def pack_bank(sph: np.ndarray, quad: np.ndarray, sph_id: np.ndarray,
              quad_id: np.ndarray) -> bytes:
    """The kernel's BankRows: the real sphere rows (n_sph, 4), quad rows
    (n_quad, 12) and their global ids, zero-padded to BANK_MAX_ROWS each
    (the kernel walks only the real ones)."""
    m = BANK_MAX_ROWS
    if len(sph) + len(quad) > m:
        raise ValueError(f"{len(sph)} + {len(quad)} rows exceed the bank's "
                         f"{m}")
    rows = np.zeros((m + 3 * m, 4), np.float32)
    rows[:len(sph)] = sph
    rows[m:m + 3 * len(quad)] = np.asarray(quad, np.float32).reshape(-1, 4)
    gid = np.zeros((2 * m,), np.int32)
    gid[:len(sph_id)] = sph_id
    gid[m:m + len(quad_id)] = quad_id
    return rows.tobytes() + gid.tobytes()


def _check(cs: CompactRows, o: torch.Tensor, d: torch.Tensor):
    for name, t in (("o", o), ("d", d)):
        if t.dtype != torch.float32 or t.dim() != 2 or t.shape[1] != 3:
            raise ValueError(f"{name} must be (R, 3) float32, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != cs.sph.device:
            raise ValueError(f"{name} on {t.device}, scene on "
                             f"{cs.sph.device}")
    if o.shape[0] != d.shape[0]:
        raise ValueError(f"{o.shape[0]} origins but {d.shape[0]} directions")
    if (tuple(cs.sph.shape[1:]) != (4,) or tuple(cs.quad.shape[1:]) != (12,)
            or cs.index_map.shape[0] != cs.ns + cs.quad.shape[0]
            or not (0 <= cs.n_sph <= cs.ns
                    and 0 <= cs.n_quad <= cs.quad.shape[0])
            or (cs.bank is not None
                and (len(cs.bank) != BANK_BYTES
                     or cs.n_sph + cs.n_quad > BANK_MAX_ROWS))):
        raise ValueError("malformed CompactRows")


def closest_hit(cs: CompactRows, o: torch.Tensor, d: torch.Tensor,
                need_j: bool = True):
    """Detached closest hit of rays (o, d), each (R, 3) f32 in any
    strides: (t (R,) f32, j (R,) i32 global id, -1 = miss), on the device
    of `cs`; j is None with `need_j=False`."""
    _check(cs, o, d)
    o, d = o.detach(), d.detach()
    if o.device.type == "cpu":
        return closest_hit_reference(cs, o, d, need_j)
    if o.device.type != "cuda":
        raise ValueError(f"no closest-hit kernel for device {o.device}")
    if cs.bank is None and any(not t.is_contiguous() or t.data_ptr() % 16
                               for t in (cs.sph, cs.quad)):
        raise ValueError("sph and quad must be contiguous and 16-byte "
                         "aligned: the kernel reads their rows as float4")
    r = o.shape[0]
    t = torch.empty((r,), dtype=torch.float32, device=o.device)
    j = (torch.empty((r,), dtype=torch.int32, device=o.device) if need_j
         else None)
    if r == 0:                      # nothing to launch
        return t, j
    lib = _build.load()
    with torch.cuda.device(o.device):
        stream = torch.cuda.current_stream(o.device).cuda_stream
        err = lib.tinyrt_closest_hit(
            o.data_ptr(), o.stride(0), o.stride(1),
            d.data_ptr(), d.stride(0), d.stride(1), cs.bank,
            cs.sph.data_ptr(), cs.n_sph, cs.quad.data_ptr(), cs.n_quad,
            cs.ns, cs.index_map.data_ptr(), t.data_ptr(),
            None if j is None else j.data_ptr(), r, stream)
    if err != 0:
        msg = lib.tinyrt_error_string(err).decode()
        raise RuntimeError(f"closest_hit launch failed: CUDA error {err} "
                           f"({msg})")
    closest_hit.launches += 1
    return t, j


closest_hit.launches = 0


def closest_hit_reference(cs: CompactRows, o: torch.Tensor, d: torch.Tensor,
                          need_j: bool = True):
    """Plain PyTorch twin of K3: the Pallas kernel's sphere and quad tests
    over (rows, rays) candidate matrices of the real rows, then the
    lowest row at the minimum. Rays go in chunks of at most
    CANDIDATE_BUDGET candidates. j is None with `need_j=False`."""
    _check(cs, o, d)
    o, d = o.detach(), d.detach()
    r = o.shape[0]
    rows = max(cs.n_sph + cs.n_quad, 1)
    step = max(1, CANDIDATE_BUDGET // rows)
    t_out = torch.empty((r,), dtype=torch.float32, device=o.device)
    j_out = torch.empty((r,), dtype=torch.int32, device=o.device)
    sph, quad = cs.sph[:cs.n_sph], cs.quad[:cs.n_quad]
    q_rows = cs.ns + torch.arange(cs.n_quad, device=o.device)
    row_id = torch.cat([torch.arange(cs.n_sph, device=o.device), q_rows])
    miss = torch.tensor(MISS_T, dtype=torch.float32, device=o.device)
    with torch.no_grad():
        for r0 in range(0, r, step):
            ox, oy, oz = o[r0:r0 + step].unbind(1)
            dx, dy, dz = d[r0:r0 + step].unbind(1)
            ts = _sphere_ts(sph, ox, oy, oz, dx, dy, dz, miss)
            tq = _quad_ts(quad, ox, oy, oz, dx, dy, dz, miss)
            t_all = torch.cat([ts, tq], 0)                   # (N, TR)
            if t_all.shape[0] == 0:
                best = miss.expand(ox.shape[0])
                j = torch.full_like(ox, -1, dtype=torch.int32)
            else:
                best = t_all.min(0).values
                n_all = t_all.shape[0]
                cand = torch.where(t_all == best[None],
                                   torch.arange(n_all, device=o.device)[:, None],
                                   n_all)
                win = row_id[cand.min(0).values]
                j = torch.where(best < miss, cs.index_map[win], -1).to(
                    torch.int32)
            t_out[r0:r0 + step] = best
            j_out[r0:r0 + step] = j
    return t_out, (j_out if need_j else None)


def _sphere_ts(sph, ox, oy, oz, dx, dy, dz, miss):
    """(Ns, TR) sphere t, intersect_pallas.py:186-200 op for op."""
    cx, cy, cz, r2 = (sph[:, k:k + 1] for k in range(4))
    ocx = ox - cx
    ocy = oy - cy
    ocz = oz - cz
    half_b = ocx * dx + ocy * dy + ocz * dz
    c_term = ocx * ocx + ocy * ocy + ocz * ocz - r2
    disc = half_b * half_b - c_term
    sqrtd = torch.sqrt(torch.clamp_min(disc, 0.0))
    t0 = -half_b - sqrtd
    t1 = -half_b + sqrtd
    ts = torch.where((t0 >= T_MIN) & (t0 < miss), t0,
                     torch.where((t1 >= T_MIN) & (t1 < miss), t1, miss))
    return torch.where(disc >= 0.0, ts, miss)


def _quad_ts(quad, ox, oy, oz, dx, dy, dz, miss):
    """(Nq, TR) quad t, intersect_pallas.py:203-230 op for op."""
    (nx, ny, nz, dp, avx, avy, avz, ca, bvx, bvy, bvz,
     cb) = (quad[:, k:k + 1] for k in range(12))
    denom = nx * dx + ny * dy + nz * dz
    ok_den = torch.abs(denom) >= 1e-12
    denom = torch.where(ok_den, denom, 1e-12)
    tq = (dp - (nx * ox + ny * oy + nz * oz)) / denom
    alpha = (avx * ox + avy * oy + avz * oz) + tq * (
        avx * dx + avy * dy + avz * dz) - ca
    beta = (bvx * ox + bvy * oy + bvz * oz) + tq * (
        bvx * dx + bvy * dy + bvz * dz) - cb
    ok = (ok_den & (tq >= T_MIN) & (tq < miss) & (alpha >= 0.0)
          & (alpha < 1.0) & (beta >= 0.0) & (beta < 1.0))
    return torch.where(ok, tq, miss)


def intersect_scene_compact(scene, cs: CompactRows, o, d) -> HitRecord:
    """Closest hit through K3 (or its twin on the CPU), gradient-equivalent
    to the dense path: selection detached, winner recomputed by prim_t."""
    t_screen, j = closest_hit(cs, o, d)
    return select_to_record(scene, o, d, t_screen, j)
