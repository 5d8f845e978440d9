"""The domain-decomposed FCN3 step: latitude over the model axis (paper
§4, G.2; the JAX package's ``sharding`` rules in ``mode="domain"``).

Every rank holds the loader's row block of each field at the IO grid and
the matching block at the latent (``compat.row_block``, ragged where the
ranks do not divide the rows), and the parameters whole.  The JAX
package gets this step from GSPMD partitioning ``core/fcn3.py``; here
every op of the step is written on local rows:

* DISCO (the encoders, the local blocks, the decoders) -- a halo
  exchange gathers the input rows that the rank's output rows' taps
  read (``halo_rows``), then the band kernel runs on the plan's band
  sliced to those output rows (``local_band_rows``), then the module's
  own merge.  Each output row is computed once, from the same taps in
  the same order as on one process; no rank builds partial sums for
  other ranks' rows (Algorithm 2's reduce-scatter moves 9.8 GB a rank at
  the ``fcn3_full`` latent, the halo 11.7 MB);
* the global blocks -- Algorithm 1 (``dist_sht``) with a longitude group
  of one rank, the spectral filter's weights taken on the rank's
  degrees.  Channels are zero-padded to a multiple of the ranks and rows
  to ``ceil(H / R)`` inside the pencils only, with zero table rows and
  degrees for the padding (``domain_sht_tables``);
* the bilinear upsample -- a halo of latent rows, poles included (a
  pole's value is its ring's mean, computed where the ring arrives);
* the rest (concatenation, GELU, the MLPs, LayerScale, softclamp) is
  pointwise.

Every exchange is a collective that every rank of the latitude group
calls in the same order, in the forward, in the recomputation of a
checkpointed block and in the backward.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core import blocks as blk
from repro_torch.core.sphere import disco as discolib
from repro_torch.core.sphere import sht as shtlib
from repro_torch.distributed import dist_sht
from repro_torch.distributed.compat import (all_to_all_v, axis_index,
                                            axis_size, row_block)
from repro_torch.kernels.config import KernelConfig


# ---------------------------------------------------------------------------
# rank-local geometry (numpy)
# ---------------------------------------------------------------------------

def _live(plan: discolib.DiscoPlan) -> np.ndarray:
    """(H_out, S): whether band tap s of output row h has a nonzero
    filter value, in the band or in the wrap rows' full-circle psi;
    memoized on the (frozen) plan."""
    cached = getattr(plan, "_live_cache", None)
    if cached is None:
        band, wrap_rows, psi_wrap = plan.banded_split()
        cached = (band != 0).any(axis=(0, 3))
        cached[wrap_rows] |= (psi_wrap != 0).any(axis=(0, 3))
        object.__setattr__(plan, "_live_cache", cached)
    return cached


def halo_rows(plan: discolib.DiscoPlan, out_lo: int, out_hi: int
              ) -> np.ndarray:
    """The sorted input rows that the live taps of output rows
    ``[out_lo, out_hi)`` read (``plan.lat_idx``), the wrap rows' included.
    Not assumed contiguous, nor held by the adjacent ranks only."""
    rows = plan.lat_idx[out_lo:out_hi][_live(plan)[out_lo:out_hi]]
    return np.unique(rows).astype(np.int64)


def local_band_rows(plan: discolib.DiscoPlan, out_block: tuple[int, int],
                    need: np.ndarray) -> dict[str, np.ndarray]:
    """``DiscoPlan.banded_buffers``' arrays for the output rows
    ``out_block`` = (lo, hi) read from the gathered input rows ``need``
    (sorted, as ``halo_rows`` gives them).

    ``psi_band`` and ``psi_wrap`` are sliced to the output rows,
    ``lat_idx`` points into ``need`` (a tap with no filter value at row
    0), ``wrap_rows`` are the block's own wrap rows numbered from ``lo``,
    and the live taps and their lists by input row are read off the
    slice, so the result feeds ``dispatch.disco_conv_banded_buffers`` on
    x of ``len(need)`` rows unchanged."""
    lo, hi = out_block
    band, wrap_rows, psi_wrap = plan.banded_split()
    pos = np.full((plan.grid_in.nlat,), -1, np.int64)
    pos[need] = np.arange(len(need))
    lat = pos[plan.lat_idx[lo:hi]]
    if (lat[_live(plan)[lo:hi]] < 0).any():
        raise ValueError(f"need misses input rows that output rows "
                         f"[{lo}, {hi}) read")
    lat = np.where(lat < 0, 0, lat).astype(np.int32)
    mine = (wrap_rows >= lo) & (wrap_rows < hi)
    psi_band = np.ascontiguousarray(band[:, lo:hi])
    taps = discolib.band_live_taps(psi_band)
    return {**taps, **discolib.band_row_taps(lat, taps, len(need)),
            "psi_band": psi_band,
            "psi_wrap": np.ascontiguousarray(psi_wrap[:, mine]),
            "wrap_rows": (wrap_rows[mine] - lo).astype(np.int64),
            "lat_idx": lat}


def _to(arrays: dict[str, np.ndarray], device) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for k, a in arrays.items()}


# ---------------------------------------------------------------------------
# the halo exchange
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Halo:
    """One rank's part in gathering the input rows each rank needs.

    ``send``: this rank's local rows that the other ranks need, the
    blocks for each peer in rank order; ``own``: its local rows it needs
    itself; ``send_sizes`` / ``recv_sizes``: rows to / from each rank (0
    for itself); ``before``: the rows received from lower ranks, which
    precede the own rows in the gathered, sorted rows.
    """

    send: torch.Tensor
    own: torch.Tensor
    send_sizes: tuple[int, ...]
    recv_sizes: tuple[int, ...]
    before: int

    @classmethod
    def of(cls, need, blocks, rank: int, device="cpu") -> "Halo":
        """Rank ``rank``'s part, from every rank's ``need`` (sorted global
        rows) and the ascending row ``blocks`` (lo, hi) the ranks hold."""
        lo, hi = blocks[rank]
        send, own, send_sizes, recv_sizes = [], None, [], []
        for q, (qlo, qhi) in enumerate(blocks):
            mine = need[q][(need[q] >= lo) & (need[q] < hi)] - lo
            theirs = need[rank][(need[rank] >= qlo) & (need[rank] < qhi)]
            if q == rank:
                own = mine
                mine = mine[:0]
                theirs = theirs[:0]
            send.append(mine)
            send_sizes.append(len(mine))
            recv_sizes.append(len(theirs))
        if sum(recv_sizes) + len(own) != len(need[rank]):
            raise ValueError("the row blocks do not cover the rows needed")

        def idx(a):
            return torch.from_numpy(np.asarray(a, np.int64)).to(device)
        return cls(idx(np.concatenate(send)), idx(own), tuple(send_sizes),
                   tuple(recv_sizes), sum(recv_sizes[:rank]))


def halo_exchange(x: torch.Tensor, halo: Halo, group) -> torch.Tensor:
    """The rows this rank needs, sorted, from x (..., H_loc, W) of every
    rank: the other ranks' through ``all_to_all_v``, its own in place.
    Differentiable: a gathered row's gradient goes back to its owner,
    which adds it in."""
    recv = all_to_all_v(x.index_select(-2, halo.send), group, -2,
                        halo.send_sizes, halo.recv_sizes)
    own = x.index_select(-2, halo.own)
    b = halo.before
    return torch.cat([recv[..., :b, :], own, recv[..., b:, :]], dim=-2)


def domain_disco(conv: discolib.DiscoConv, x: torch.Tensor, buffers: dict,
                 stride: int, halo: Halo, group,
                 kernels: KernelConfig | None = None) -> torch.Tensor:
    """``conv`` on this rank's output rows: the halo exchange of its
    input block x (..., C_in, H_loc, W), then the band kernel (at
    ``kernels``' tile) on the sliced band (``buffers``:
    ``local_band_rows``' tensors) and the module's merge with its own
    weights."""
    return conv(halo_exchange(x, halo, group), buffers, stride,
                kernels=kernels)


def domain_upsample(resample, x: torch.Tensor, halo: Halo, rows: np.ndarray,
                    out_block: tuple[int, int], group) -> torch.Tensor:
    """``BilinearResample`` onto this rank's output rows ``out_block``
    from its latent block x (..., C, H_loc, W): the latent rows ``rows``
    (``resample.input_rows(out_block)``) gathered by ``halo``."""
    return resample.resample_rows(halo_exchange(x, halo, group), rows,
                                  out_block)


# ---------------------------------------------------------------------------
# Algorithm 1 on row blocks
# ---------------------------------------------------------------------------

def domain_sht_tables(sht: shtlib.SHT, blocks, device="cpu",
                      inverse: bool = False) -> dict[str, torch.Tensor]:
    """``sht``'s tables laid out for ``domain_sht_forward`` / ``_inverse``
    over the ranks' row ``blocks``: (R * Hp, Lp, M) float32, Hp =
    max rows of a block, Lp = lmax rounded up to a multiple of R; rank
    q's rows at ``q * Hp``, zero rows for the padding of a shorter block
    and zero degrees past lmax, so padding adds nothing; each table with
    its ``order_extents``.  ``pct`` only with ``inverse``."""
    n = len(blocks)
    hp = max(hi - lo for lo, hi in blocks)
    lp = -(-sht.lmax // n) * n
    out = {}
    for name, table in zip(("wpct", "pct"), sht.tables()):
        if name == "pct" and not inverse:
            break
        pad = np.zeros((n * hp, lp, sht.mmax), np.float32)
        for q, (lo, hi) in enumerate(blocks):
            pad[q * hp:q * hp + hi - lo, :sht.lmax] = table[lo:hi]
        out[name] = torch.from_numpy(pad).to(device)
        out[f"{name}_ext"] = torch.from_numpy(
            shtlib.order_extents(pad)).to(device)
    return out


def _channels(x: torch.Tensor, n: int) -> tuple[torch.Tensor, int]:
    """x (..., A, B) as (C, A, B), C zero-padded to a multiple of n."""
    x = x.reshape((-1,) + tuple(x.shape[-2:]))
    c = x.shape[0]
    return F.pad(x, (0, 0, 0, 0, 0, -c % n)), c


def domain_sht_forward(x: torch.Tensor, tables: dict, group, solo,
                       kernels: KernelConfig | None = None) -> torch.Tensor:
    """Forward SHT of this rank's rows x (..., H_loc, W): Algorithm 1
    (``dist_sht_forward``) with ``solo``, a group of this rank alone, for
    longitude.  Returns (..., Lp / R, M) complex64, this rank's block of
    degrees (zero past lmax)."""
    n = axis_size(group)
    hp = tables["wpct"].shape[0] // n
    lead = x.shape[:-2]
    xr, c = _channels(F.pad(x, (0, 0, 0, hp - x.shape[-2])), n)
    out = dist_sht.dist_sht_forward(xr, tables, tables["wpct"].shape[2],
                                    group, solo, kernels)
    return out[:c].reshape(lead + tuple(out.shape[-2:]))


def domain_sht_inverse(c: torch.Tensor, tables: dict, nlon: int, rows: int,
                       group, solo, kernels: KernelConfig | None = None
                       ) -> torch.Tensor:
    """Inverse SHT of this rank's block of degrees c (..., Lp / R, M)
    onto its ``rows`` rows: (..., rows, nlon) float32."""
    lead = c.shape[:-2]
    cr, k = _channels(c, axis_size(group))
    u = dist_sht.dist_sht_inverse(cr, tables, nlon, group, solo, kernels)
    return u[:k, :rows].reshape(lead + (rows, nlon))


def degree_block(w: torch.Tensor, lloc: int, group) -> torch.Tensor:
    """(..., L) per-degree values on this rank's block of ``lloc``
    degrees, zero past L."""
    n, r = axis_size(group), axis_index(group)
    w = F.pad(w, (0, n * lloc - w.shape[-1]))
    return w[..., r * lloc:(r + 1) * lloc]


def domain_spectral(filt, x: torch.Tensor, tables: dict, group, solo,
                    kernels: KernelConfig | None = None) -> torch.Tensor:
    """A ``SpectralFilter`` (FCN3's global blocks) on this rank's rows x
    (..., C_in, H_loc, W): the forward SHT, the filter's
    ``apply_weights`` on the rank's degrees, the inverse SHT (the
    Legendre kernel at ``kernels``' tile)."""
    c = domain_sht_forward(x, tables, group, solo, kernels)
    lloc = c.shape[-2]                                    # (.., C, Lloc, M)
    y = filt.apply_weights(c, lambda w: degree_block(w, lloc, group))
    return domain_sht_inverse(y, tables, x.shape[-1], x.shape[-2], group,
                              solo, kernels)


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

class DomainFCN3:
    """``FCN3.forward`` on this rank's latitude rows, with the model's
    own parameters (replicated, as ``sharding.fcn3_param_specs(mode=
    "domain")`` places them).

    ``group``: the latitude group (the mesh's model axis).  Construction
    is collective over the world (it makes each rank a group of its own,
    Algorithm 1's longitude group).  ``make_buffers`` builds only this
    rank's slices of the plans and tables.
    """

    def __init__(self, model, group):
        import torch.distributed as dist
        cfg = model.cfg
        if cfg.kernels.disco != "kernel" or cfg.kernels.sht != "kernel":
            raise ValueError(f"the domain step runs the kernels' layouts, "
                             f"not {cfg.kernels}")
        self.model, self.group = model, group
        self.solo = dist.new_subgroups(1)[0]
        n, r = axis_size(group), axis_index(group)
        self.io_blocks = [row_block(cfg.nlat, q, n) for q in range(n)]
        self.lat_blocks = [row_block(cfg.latent_nlat, q, n)
                           for q in range(n)]
        self.io_block, self.lat_block = self.io_blocks[r], self.lat_blocks[r]
        outs = {"enc": self.lat_blocks, "latent": self.lat_blocks,
                "up": self.io_blocks, "dec": self.io_blocks}
        ins = {"enc": self.io_blocks, "latent": self.lat_blocks,
               "up": self.lat_blocks, "dec": self.io_blocks}
        plans = {"enc": model.enc_plan, "latent": model.latent_plan,
                 "dec": model.dec_plan}
        needs = {k: [model.upsample.input_rows(b) if k == "up"
                     else halo_rows(plans[k], *b) for b in outs[k]]
                 for k in outs}
        self.need = {k: v[r] for k, v in needs.items()}
        self.halos = {k: Halo.of(needs[k], ins[k], r, model.device)
                      for k in needs}
        self._plans = plans

    def make_buffers(self) -> dict:
        """This rank's slices: ``local_band_rows`` of the encoder, latent
        and decoder plans and the latent SHT's ``domain_sht_tables``."""
        dev = self.model.device
        outs = {"enc": self.lat_block, "latent": self.lat_block,
                "dec": self.io_block}
        bufs = {k: _to(local_band_rows(self._plans[k], outs[k],
                                       self.need[k]), dev) for k in outs}
        bufs["latent_sht"] = domain_sht_tables(
            self.model.latent_sht, self.lat_blocks, dev, inverse=True)
        return bufs

    def _block(self, block, x, cond, buf):
        cond = cond.expand(x.shape[:-3] + cond.shape[-3:])
        h = torch.cat([x, cond], dim=-3)
        if block.spec.kind == "local":
            h = domain_disco(block.conv, h, buf, 1, self.halos["latent"],
                             self.group, self.model.cfg.kernels)
        else:
            h = domain_spectral(block.conv, h, buf, self.group, self.solo,
                                self.model.cfg.kernels)
        return block.mix(x, h)

    def __call__(self, buffers: dict, state: torch.Tensor,
                 cond_in: torch.Tensor) -> torch.Tensor:
        """One step on this rank's rows (``FCN3.forward``): state
        (..., n_state, H_loc, W) and cond_in (..., n_cond_in, H_loc, W) on
        the rank's IO rows; returns u_{n+1} on the same rows.  With
        gradients on each processor block is recomputed in backward, its
        exchanges with it."""
        m, g = self.model, self.group
        x, cond = m._encode(buffers,
                            halo_exchange(state, self.halos["enc"], g),
                            halo_exchange(cond_in, self.halos["enc"], g))
        remat = torch.is_grad_enabled() and (
            x.requires_grad
            or any(p.requires_grad for p in m.blocks.parameters()))
        for block in m.blocks:
            buf = (buffers["latent"] if block.spec.kind == "local"
                   else buffers["latent_sht"])
            if remat:
                x = checkpoint(self._block, block, x, cond, buf,
                               use_reentrant=False)
            else:
                x = self._block(block, x, cond, buf)
        del cond
        up = domain_upsample(m.upsample, x, self.halos["up"],
                             self.need["up"], self.io_block, g)
        out = m._decoders(buffers, halo_exchange(up, self.halos["dec"], g))
        return torch.where(m.water_mask, blk.softclamp(out), out)
