"""The three transport stencils on latitude strips.

Twin of `cam_nor_physics_tpu.parallel.shard_stencil`, where JAX runs its
Pallas kernels under shard_map. Here, on a `Mesh` of ranks:

  1. every operand of the rank's strip is extended by `_HALO` = 5 rows
     from each neighbour along y, one `torch.distributed.batch_isend_irecv`
     a call with the operands packed row by row (the mp_send4d_ns role);
     beyond the globe's edges the exchange gives zero rows;
  2. the kernel wrapper of ops/stencil_kernels (the CUDA kernel on a
     card, its plain version on the CPU) runs on the extended strip, and
     the rank keeps its own rows: tp_core's y-stencils reach at most 4
     rows, and the strip's ends, which the kernel treats as poles, change
     at most the 4 rows next to them (JAX's _POLE_ROWS), all halo;
  3. an edge rank takes no halo on its polar side: its strip ends at the
     true pole, so the pole rows (adx = q there, the cross-pole mirrors of
     ymist and fyppm, the polar caps) come from the kernel itself, and
     JAX's 8-row polar patch is not needed. That is why a strip must hold
     at least `MIN_ROWS` = 8 rows (JAX's jm/ny >= 8).

The interior arithmetic is the whole-slab kernel's, so a strip's rows
equal the whole slab's bitwise. x must be unsharded (`use_sharded_pallas`,
JAX's rules). The `sharded_*` functions take the rank's strips, as JAX's
do. cd_step and trac2d, whose glue is replicated, call `whole_call`
instead: every rank holds the whole operands, so it cuts its extended
strip locally (steps 2 and 3, no exchange) and the outputs are gathered
whole. The exchange of step 1 serves a caller that holds only its strips.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops import stencil_kernels as sk
from .mesh import Mesh

_HALO = 5          # rows from each neighbour (ops/pallas_kernels._HALO)
MIN_ROWS = 8       # rows a strip must hold (JAX's jm/ny >= 8)


def check_mesh(mesh):
    """Raise TypeError unless `mesh` is None or a port Mesh."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.mesh.Mesh, got "
                        f"{type(mesh).__name__}")


def use_sharded_pallas(mesh) -> bool:
    """True when the strip stencils apply to `mesh`: y sharded (ny >= 2)
    and x unsharded, JAX's rules (its shard_stencil.py:48-60; the port's
    kernels run on either device, so there is no backend condition)."""
    check_mesh(mesh)
    if mesh is None:
        return False
    return mesh.shape["x"] == 1 and mesh.shape["y"] >= 2


def use_strips(mesh, jm: int) -> bool:
    """use_sharded_pallas and the strip conditions of JAX's cd_step and
    trac2d: jm % ny == 0 and jm / ny >= MIN_ROWS."""
    return (use_sharded_pallas(mesh) and jm % mesh.ny == 0
            and jm // mesh.ny >= MIN_ROWS)


def strip_extent(jm: int, y: int, ny: int, h: int = _HALO):
    """(lo, hi, start): the global rows [lo, hi) of strip y's extended
    strip, and where its own rows start in it."""
    n = jm // ny
    lo = y * n - (h if y > 0 else 0)
    hi = (y + 1) * n + (h if y < ny - 1 else 0)
    return lo, hi, y * n - lo


def row_axis(t) -> int:
    """The latitude axis: -2 of a (..., rows, im) slab, -1 of the (km,
    rows) FFSL flags and the (rows,) row tables."""
    return -2 if t.dim() >= 3 else -1


def _rows_first(t):
    ax = row_axis(t)
    return t.movedim(ax, 0).reshape(t.shape[ax], -1)


def halo_rows(mesh: Mesh, buf, h: int = _HALO):
    """(south, north): the last h rows of the strip south of this rank's
    and the first h of the one north of it, for a (rows, w) buffer; zero
    rows beyond the globe's edges."""
    y = mesh.y_index
    south = buf.new_zeros((h,) + tuple(buf.shape[1:]))
    north = buf.new_zeros((h,) + tuple(buf.shape[1:]))
    ops = []
    if y > 0:
        peer = mesh.rank_at(y - 1)
        ops += [dist.P2POp(dist.isend, buf[:h].contiguous(), peer),
                dist.P2POp(dist.irecv, south, peer)]
    if y < mesh.ny - 1:
        peer = mesh.rank_at(y + 1)
        ops += [dist.P2POp(dist.isend, buf[-h:].contiguous(), peer),
                dist.P2POp(dist.irecv, north, peer)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return south, north


def halo_extend(mesh: Mesh, arrays, h: int = _HALO):
    """The operands of this rank's strip extended by the neighbours' h
    rows (none on an edge rank's polar side); the arrays go as one
    buffer in the first's dtype, the FFSL flags as 0 and 1."""
    dtype = arrays[0].dtype
    cols = [_rows_first(a.to(dtype)) for a in arrays]
    south, north = halo_rows(mesh, torch.cat(cols, 1), h)
    y = mesh.y_index
    out, o = [], 0
    for a, c in zip(arrays, cols):
        w = c.shape[1]
        parts = ([south[:, o:o + w]] if y > 0 else []) + [c] + \
            ([north[:, o:o + w]] if y < mesh.ny - 1 else [])
        ext = torch.cat(parts, 0)
        o += w
        ax = row_axis(a)
        rest = tuple(a.movedim(ax, 0).shape[1:])
        ext = ext.reshape((ext.shape[0],) + rest).movedim(0, ax)
        out.append((ext > 0.5 if a.dtype == torch.bool else ext).contiguous())
    return out


def strip_call(name: str, ext, scalars, y: int, rows: int):
    """Stencil `name` of ops/stencil_kernels on strip y's extended
    operands `ext` (no FFSL band; the scalars rcap, iord, jord as it
    takes them), then the strip's own `rows` rows of its outputs."""
    out = getattr(sk, name)(*ext, *scalars)
    s = _HALO if y > 0 else 0

    def one(o):
        return o[..., s:s + rows, :].contiguous()
    return tuple(one(o) for o in out) if isinstance(out, tuple) else one(out)


def cut_strip(args, y: int, ny: int):
    """Strip y of ny's extended operands cut from whole ones: what the
    halo exchange delivers (the one-process check of the strips)."""
    out = []
    for a in args:
        if isinstance(a, torch.Tensor):
            ax = row_axis(a)
            lo, hi, _ = strip_extent(a.shape[ax], y, ny)
            a = a.narrow(ax, lo, hi - lo).contiguous()
        out.append(a)
    return out


def sharded_transport3d(mesh: Mesh, delp, pt, crx, cry, yfx, va, ffsl,
                        cosp, acosp, rcap: float, iord: int, jord: int):
    """transport3d on this rank's strip: (km, rows, im) operands, ffsl
    (km, rows), cosp and acosp (rows,). Returns the strip's (ddp, dpt,
    mfx, mfy)."""
    ext = halo_extend(mesh, [delp, pt, crx, cry, yfx, va, ffsl, cosp,
                             acosp])
    return strip_call("transport3d", ext, (rcap, iord, jord), mesh.y_index,
                      delp.shape[-2])


def sharded_vort_flux3d(mesh: Mesh, zeta, crx, cry, udt, vedt, ffsl, cosp,
                        iord: int, jord: int):
    """vort_flux3d on this rank's strip. Returns the strip's (fx, fy)."""
    ext = halo_extend(mesh, [zeta, crx, cry, udt, vedt, ffsl, cosp])
    return strip_call("vort_flux3d", ext, (iord, jord), mesh.y_index,
                      zeta.shape[-2])


def sharded_tracer_div3d(mesh: Mesh, q, crx, cry, mfx, mfy, va, ffsl, cosp,
                         acosp, rcap: float, iord: int, jord: int):
    """tracer_div3d on this rank's strip: q (nq, km, rows, im). Returns
    the strip's dqm."""
    ext = halo_extend(mesh, [q, crx, cry, mfx, mfy, va, ffsl, cosp, acosp])
    return strip_call("tracer_div3d", ext, (rcap, iord, jord), mesh.y_index,
                      q.shape[-2])


def whole_call(mesh: Mesh, name: str, *args):
    """Stencil `name` of ops/stencil_kernels on whole operands, which every
    rank holds (the replicated glue of cd_step and trac2d): each rank cuts
    its extended strip from them (cut_strip: the halo rows are in its own
    memory, so nothing is exchanged), runs the kernel on it, and every
    rank gets the whole outputs back, gathered in one all-gather."""
    n = next(i for i, a in enumerate(args) if not isinstance(a, torch.Tensor))
    y = mesh.y_index
    out = strip_call(name, cut_strip(args[:n], y, mesh.ny), args[n:], y,
                     args[0].shape[-2] // mesh.ny)
    if not isinstance(out, tuple):
        return mesh.gather_rows(out, -2)
    return tuple(mesh.gather_rows(torch.stack(out), -2).unbind(0))
