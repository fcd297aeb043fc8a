"""Mamba2 block: state-space duality (SSD) with chunked scan.

Follows the Mamba2 formulation (arXiv:2405.21060): input projections to
(z, x, B, C, dt), short depthwise conv on (x, B, C), SSD chunked scan with
scalar-per-head decay A, gated RMSNorm, output projection.  B and C come in
``cfg.ssm_groups`` groups of ``ssm_state`` columns: head h reads group
h // (heads / groups), and the gated norm works on each group's channels
(zamba2's and falcon_h1's two groups; every other family has one).  ``cfg.ssm_dt_min``
floors dt after its softplus, as the published Zamba2 Mixer does.  The inner width
is ``cfg.ssm_d_inner`` (falcon_h1 sets its own, ``ssm_inner``), and falcon_h1's µP
multipliers scale the five projections: ``ssm_in_multiplier`` times each of
``ssm_multipliers``, folded into one scalar a projection (``mup``), a plain float
that multiplies nothing where it is 1.

Parameters keep the reference's names and layouts: the projections are
separate (wz/wx/wb/wc/wdt, each (d_model, out) and applied as ``x @ w``), the
conv weights are (conv_width, channels).  Params are stored in
``cfg.param_dtype`` and cast to ``cfg.compute_dtype`` at use; ``dt``, ``a``
and the decode state are float32.

The chunked scan is ``repro_torch.kernels.ssd_scan.ops.ssd_scan``: the CUDA
kernel on the card, the plain reference on the CPU.  Decode keeps a
constant-size recurrent state (B, H, P, N) plus a (conv_width-1)-deep conv
cache of the pre-conv (x|B|C) inputs; its state update and the contraction
with C are ``repro_torch.kernels.ssm_decode.ops.ssm_decode``: on the card one
pass of the CUDA kernel over the state, into the destination the caller
names; on the CPU the plain reference.

Under tensor parallelism (``tp_group`` set by a sharded step, ``sharding/tp.py``)
the mixer holds its model-axis shards of ``wz``, ``wx``, ``wdt``, ``conv_x``,
``a_log``, ``dt_bias``, ``d_skip`` and ``out_proj`` and runs the scan on its
H/tp heads; ``wb``, ``wc`` and the B/C convs stay replicated, and the gated
norm reduces its sum of squares over the group.  The decode state holds the
rank's heads; the conv cache stays whole, and the rank reads its x channels
from it and gathers the x part it writes back.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.ssd_scan import ops as ssd_ops
from ..kernels.ssm_decode import ops as ssm_decode_ops
from ..sharding import tp
from .config import ArchConfig
from .layers import _dtype, _normal, _param, rmsnorm_grouped, rmsnorm_init, rmsnorm_split, scaled


def _causal_conv(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, width W.  x: (B,S,C); w: (W,C).

    Unrolled shifted adds, as the reference; no cuDNN (whose float32
    convolution defaults to TF32).
    """
    wwidth = w.shape[0]
    pad = F.pad(x, (0, 0, wwidth - 1, 0))
    out = torch.zeros_like(x)
    for i in range(wwidth):
        out = out + pad[:, i : i + x.shape[1], :] * w[i]
    return out + b


def ssm_init_cache(cfg: ArchConfig, batch: int, dtype, device) -> dict[str, torch.Tensor]:
    h, pdim, n = cfg.ssm_num_heads, cfg.ssm_head_dim, cfg.ssm_state
    conv_dim = cfg.ssm_d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    return {
        "state": torch.zeros((batch, h, pdim, n), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, conv_dim), dtype=dtype, device=device),
    }


class Mamba2Mixer(nn.Module):
    tp_group: tp.Group | None = None

    def __init__(self, cfg: ArchConfig, generator: torch.Generator, device):
        super().__init__()
        self.cfg = cfg
        dt = _dtype(cfg.param_dtype)
        d, di, h = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_num_heads
        gn, w = cfg.ssm_groups * cfg.ssm_state, cfg.ssm_conv_width
        s = d**-0.5

        def normal(shape, scale):
            return _normal(shape, scale, dt, generator, device)

        def const(t):
            return _param(t.to(dtype=dt, device=device))

        self.wz = normal((d, di), s)
        self.wx = normal((d, di), s)
        self.wb = normal((d, gn), s)
        self.wc = normal((d, gn), s)
        self.wdt = normal((d, h), s)
        self.conv_x = normal((w, di), 0.2)
        self.conv_bx = const(torch.zeros(di))
        self.conv_b = normal((w, gn), 0.2)
        self.conv_bb = const(torch.zeros(gn))
        self.conv_c = normal((w, gn), 0.2)
        self.conv_bc = const(torch.zeros(gn))
        self.a_log = const(torch.log(torch.linspace(1.0, 16.0, h)))
        self.dt_bias = const(torch.zeros(h))
        self.d_skip = const(torch.ones(h))
        self.norm = rmsnorm_init(di, dt, device)
        self.out_proj = normal((di, d), di**-0.5)
        # the scale of each of z, x, B, C and dt: the input's times the projection's (falcon_h1's µP)
        self.mup = tuple(cfg.ssm_in_multiplier * m for m in cfg.ssm_multipliers or (1.0,) * 5)

    def _project(self, xc: torch.Tensor):
        cd, g = xc.dtype, self.tp_group
        xc = tp.copy(xc, g)
        wb, wc = tp.copy(self.wb, g), tp.copy(self.wc, g)
        return tuple(scaled(xc @ w.to(cd), m) for w, m in zip((self.wz, self.wx, wb, wc, self.wdt), self.mup))

    def _convs(self) -> tuple[torch.Tensor, ...]:
        """(conv_x, conv_bx, conv_b, conv_bb, conv_c, conv_bc) as this rank reads them:
        under TP its channels of x (``conv_bx`` is replicated, so sliced) and the
        replicated B and C convs whole."""
        g = self.tp_group
        if g is None:
            return self.conv_x, self.conv_bx, self.conv_b, self.conv_bb, self.conv_c, self.conv_bc
        return (self.conv_x, tp.part(self.conv_bx, 0, g),
                *(tp.copy(w, g) for w in (self.conv_b, self.conv_bb, self.conv_c, self.conv_bc)))

    def _gate_out(self, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        g = self.tp_group
        if g is None:
            y = rmsnorm_grouped(self.norm, y * F.silu(z), self.cfg.norm_eps, self.cfg.ssm_groups)
        else:
            y = rmsnorm_split(self.norm, y * F.silu(z), self.cfg.norm_eps, g)
        return tp.reduce(y @ self.out_proj.to(y.dtype), g)

    def _dt(self, dt_raw: torch.Tensor) -> torch.Tensor:
        dt = F.softplus(dt_raw.to(torch.float32) + self.dt_bias.to(torch.float32))
        return dt.clamp(min=self.cfg.ssm_dt_min) if self.cfg.ssm_dt_min else dt

    def forward(self, xin: torch.Tensor, return_state: bool = False):
        """Full-sequence SSD.  xin: (B,S,D) -> out (B,S,D).

        With ``return_state`` also returns (final_state, conv_tail) where
        ``conv_tail`` holds the last (conv_width-1) *pre-conv* (x|B|C) inputs,
        matching the decode conv-cache layout, so prefill hands off to decode.
        """
        cfg = self.cfg
        cd = _dtype(cfg.compute_dtype)
        b, s, _ = xin.shape
        # this rank's heads and inner channels: the config's without TP
        h, di = self.wdt.shape[1], self.wx.shape[1]
        pdim, n, g = cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups
        z, x_raw, b_raw, c_raw, dt_raw = self._project(xin.to(cd))

        conv_x, conv_bx, conv_b, conv_bb, conv_c, conv_bc = self._convs()
        x = F.silu(_causal_conv(conv_x.to(cd), conv_bx.to(cd), x_raw))
        bmat = F.silu(_causal_conv(conv_b.to(cd), conv_bb.to(cd), b_raw))
        cmat = F.silu(_causal_conv(conv_c.to(cd), conv_bc.to(cd), c_raw))
        x = x.reshape(b, s, h, pdim)
        bmat = bmat.reshape(b, s, g, n)
        cmat = cmat.reshape(b, s, g, n)
        dt = self._dt(dt_raw)
        a = -torch.exp(self.a_log.to(torch.float32))

        y, state = ssd_ops.ssd_scan(x, dt, a, bmat, cmat, chunk=cfg.ssm_chunk)
        y = y.to(cd) + x * self.d_skip.to(cd)[None, None, :, None]
        out = self._gate_out(y.reshape(b, s, di), z)
        if return_state:
            w = cfg.ssm_conv_width - 1
            if self.tp_group is None:  # cut before the cat: a view of the whole cat would hold it alive
                tail = torch.cat([x_raw[:, -w:], b_raw[:, -w:], c_raw[:, -w:]], dim=-1)
            else:
                tail = torch.cat([tp.gather(x_raw[:, -w:], -1, self.tp_group), b_raw[:, -w:], c_raw[:, -w:]], dim=-1)
            if s < w:
                tail = F.pad(tail, (0, 0, w - s, 0))
            return out, state, tail
        return out

    def init_cache(self, batch: int, dtype) -> dict[str, torch.Tensor]:
        return ssm_init_cache(self.cfg, batch, dtype, self.wz.device)

    def decode(self, xin: torch.Tensor, cache: dict[str, torch.Tensor], out: torch.Tensor):
        """Single-token recurrent step.  xin: (B,1,D) -> (out (B,1,D), new cache).

        The new state is written into ``out``, a tensor of the state's shape, which may be
        ``cache["state"]`` itself: the update is then in place.
        The update and its contraction with C are ``kernels/ssm_decode``'s (under ``tp_group`` over
        the rank's heads): the CUDA kernel on the card, which raises for what it cannot take, and
        the plain reference on the CPU."""
        cfg = self.cfg
        cd = _dtype(cfg.compute_dtype)
        b = xin.shape[0]
        h, di = self.wdt.shape[1], self.wx.shape[1]  # this rank's, as in forward
        pdim, n, g = cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups
        z, x_raw, b_raw, c_raw, dt_raw = self._project(xin.to(cd))

        conv = cache["conv"]
        if self.tp_group is not None:  # the whole [x | B | C] history: this rank's x channels, all of B and C
            conv = torch.cat([conv[..., self.tp_group.rank * di:(self.tp_group.rank + 1) * di],
                              conv[..., cfg.ssm_d_inner:]], dim=-1)
        new_col = torch.cat([x_raw[:, 0], b_raw[:, 0], c_raw[:, 0]], dim=-1)  # (B, conv_dim)
        hist = torch.cat([conv.to(cd), new_col[:, None, :]], dim=1)  # (B,W,C)
        conv_x, conv_bx, conv_b, conv_bb, conv_c, conv_bc = self._convs()
        wfull = torch.cat([conv_x, conv_b, conv_c], dim=1).to(cd)
        bfull = torch.cat([conv_bx, conv_bb, conv_bc]).to(cd)
        conv_out = F.silu((hist * wfull).sum(dim=1) + bfull)
        x = conv_out[:, :di].reshape(b, h, pdim)
        bvec = conv_out[:, di : di + g * n].reshape(b, g, n)
        cvec = conv_out[:, di + g * n :].reshape(b, g, n)
        dt = self._dt(dt_raw[:, 0])  # (B,H)
        a = -torch.exp(self.a_log.to(torch.float32))

        state, y = ssm_decode_ops.ssm_decode(cache["state"], x, dt, a, bvec, cvec, out=out)
        y = y.to(cd) + x * self.d_skip.to(cd)[None, :, None]
        y = self._gate_out(y.reshape(b, 1, di), z)
        hist = hist[:, 1:, :]
        if self.tp_group is not None:
            hist = torch.cat([tp.gather(hist[..., :di], -1, self.tp_group), hist[..., di:]], dim=-1)
        return y, {"state": state, "conv": hist.to(cache["conv"].dtype)}

