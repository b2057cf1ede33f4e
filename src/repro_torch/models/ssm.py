"""Mamba-2 SSD mixer (the counterpart of ``repro.models.ssm``).

Prefill and the cache-free forward run the chunked SSD through the
``ssd_scan`` kernel (``ops.ssd_scan``; its plain version
``kernels/ref.py`` ``ssd_chunked`` serves CPU tensors). Decode is the O(1)
recurrent update, plain PyTorch. The module is dimension-parametric so the
hybrid (Hymba) architecture reuses it for its SSM heads.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init, rms_normalize


@dataclass(frozen=True)
class SSMDims:
    d_model: int
    d_inner: int
    nheads: int
    headdim: int
    nstate: int
    conv_width: int = 4
    chunk: int = 256

    @property
    def conv_ch(self) -> int:
        return self.d_inner + 2 * self.nstate


def ssm_dims(cfg) -> SSMDims:
    d_inner = cfg.ssm_expand * cfg.d_model
    return SSMDims(d_model=cfg.d_model, d_inner=d_inner,
                   nheads=d_inner // cfg.ssm_head_dim,
                   headdim=cfg.ssm_head_dim, nstate=cfg.ssm_state,
                   conv_width=cfg.ssm_conv_width, chunk=cfg.ssm_chunk)


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def init_ssm(gen: torch.Generator, dims: SSMDims, dtype=torch.float32
             ) -> Dict:
    d_in, h, dev = dims.d_inner, dims.nheads, gen.device
    proj_out = 2 * d_in + 2 * dims.nstate + h        # z, x, B, C, dt
    f32 = torch.float32

    def log_uniform(lo, hi):
        u = torch.empty((h,), dtype=f32, device=dev)
        return torch.exp(u.uniform_(math.log(lo), math.log(hi),
                                    generator=gen))

    a = log_uniform(1.0, 4.0)             # A in [-4, -1]
    dt0 = log_uniform(1e-3, 1e-1)         # softplus(dt_bias) in [1e-3, 1e-1]
    conv_w = torch.randn((dims.conv_width, dims.conv_ch), generator=gen,
                         dtype=f32, device=dev) * 0.1
    return {
        "in_proj": dense_init(gen, dims.d_model, (dims.d_model, proj_out),
                              dtype),
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros((dims.conv_ch,), dtype=dtype, device=dev),
        "A_log": torch.log(a),                                   # f32
        "dt_bias": dt0 + torch.log(-torch.expm1(-dt0)),          # f32
        "D": torch.ones((h,), dtype=f32, device=dev),
        "norm_scale": torch.ones((d_in,), dtype=dtype, device=dev),
        "out_proj": dense_init(gen, d_in, (d_in, dims.d_model), dtype),
    }


def _split_proj(p, x, dims: SSMDims):
    """-> (z, conv input [x | B | C], dt), views of one projection."""
    zxbcdt = x @ p["in_proj"]
    d_in, n = dims.d_inner, dims.nstate
    z = zxbcdt[..., :d_in]
    conv_in = zxbcdt[..., d_in:2 * d_in + 2 * n]
    dt = zxbcdt[..., 2 * d_in + 2 * n:]
    return z, conv_in, dt


def _causal_conv(p, u: torch.Tensor, dims: SSMDims) -> torch.Tensor:
    """Depthwise causal conv via shifted adds (width <= 4). u: [B,S,ch]."""
    w = p["conv_w"].to(u.dtype)
    out = torch.zeros_like(u)
    width = dims.conv_width
    for i in range(width):
        shift = width - 1 - i
        shifted = (u if shift == 0
                   else F.pad(u, (0, 0, shift, 0))[:, :-shift])
        out = out + shifted * w[i]
    return F.silu(out + p["conv_b"].to(u.dtype))


def ssd_decode_step(state, x, dt, A, B, C):
    """One-token recurrence. state: [b,h,p,n]; x: [b,h,p]; dt: [b,h];
    B, C: [b,n]. Returns (y [b,h,p], new_state)."""
    f32 = torch.float32
    decay = torch.exp((dt * A[None]).to(f32))                  # [b,h]
    xd = (x * dt[..., None]).to(f32)
    upd = torch.einsum("bhp,bn->bhpn", xd, B.to(f32))
    new_state = state * decay[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", new_state, C.to(f32))
    return y.to(x.dtype), new_state


# ---------------------------------------------------------------------------
# Full mixer block (in_proj -> conv -> SSD -> gated norm -> out_proj)
# ---------------------------------------------------------------------------

def init_ssm_cache(batch: int, dims: SSMDims, dtype=torch.float32,
                   device=None) -> Dict:
    return {
        "conv": torch.zeros((batch, dims.conv_width - 1, dims.conv_ch),
                            dtype=dtype, device=device),
        "state": torch.zeros((batch, dims.nheads, dims.headdim, dims.nstate),
                             dtype=torch.float32, device=device),
    }


def ssm_mixer(p: Dict, x: torch.Tensor, dims: SSMDims, *,
              cache: Optional[Dict] = None,
              ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x: [B,S,d_model] -> [B,S,d_model]. S==1 with cache => decode.
    Returns the new ``{"conv", "state"}`` when a cache is given."""
    b, s, _ = x.shape
    h, pdim, n = dims.nheads, dims.headdim, dims.nstate
    z, conv_in, dt_raw = _split_proj(p, x, dims)
    A = -torch.exp(p["A_log"])                                  # [h] < 0
    dt = F.softplus(dt_raw.to(torch.float32) + p["dt_bias"])

    if cache is not None and s == 1:
        full = torch.cat([cache["conv"], conv_in], dim=1)
        w = p["conv_w"].to(x.dtype)
        u = F.silu(torch.einsum("bwc,wc->bc", full, w)
                   + p["conv_b"].to(x.dtype))                  # [B,ch]
        xc, Bm, Cm = torch.split(u, [dims.d_inner, n, n], dim=-1)
        xh = xc.reshape(b, h, pdim)
        y, new_state = ssd_decode_step(cache["state"], xh, dt[:, 0], A, Bm,
                                       Cm)
        y = y + p["D"].to(y.dtype)[None, :, None] * xh
        y = y.reshape(b, 1, dims.d_inner)
        cache = {"conv": full[:, 1:], "state": new_state}
    else:
        u = _causal_conv(p, conv_in, dims)                     # [B,S,ch]
        xc, Bm, Cm = torch.split(u, [dims.d_inner, n, n], dim=-1)
        xh = xc.reshape(b, s, h, pdim)
        init_state = cache["state"] if cache is not None else None
        chunk = min(dims.chunk, s)
        while s % chunk:                                       # largest divisor
            chunk -= 1
        y, final_state = ops.ssd_scan(xh, dt, A, Bm, Cm, chunk=chunk,
                                      initial_state=init_state)
        y = y + p["D"].to(y.dtype)[None, None, :, None] * xh
        y = y.reshape(b, s, dims.d_inner)
        if cache is not None:                                  # prefill
            cache = {"conv": conv_in[:, -(dims.conv_width - 1):],
                     "state": final_state}

    y = rms_normalize(y * F.silu(z), p["norm_scale"])
    return y @ p["out_proj"], cache
