"""Mamba2 block (arXiv:2405.21060), the trunk of the Zamba2 hybrid.

State per block: the SSM state [B, H, N, P] (f32) and the causal-conv tail
[B, conv_dim, K-1] (f32).  Parameters keep the JAX package's names and
layouts (``wz [d, H, P]``, ``conv_w [conv_dim, K]``, ``wo [H, P, d]``).

Every prefill runs the chunked SSD scan once per block: ``impl="kernel"``
(the default) calls :func:`repro_torch.kernels.mamba2_ssd.mamba2_ssd`, which
launches the CUDA kernel for tensors on the card and takes the plain version
for tensors on the CPU; ``impl="plain"`` calls the plain version on either.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.config import ArchConfig
from repro_torch.kernels.mamba2_ssd import ops as ssd_ops
from repro_torch.kernels.mamba2_ssd.ref import mamba2_ssd_chunked
from repro_torch.models.layers import dense_init, param, rms_norm

State = Dict[str, torch.Tensor]
IMPLS = ("kernel", "plain")


def ssd(impl: str):
    """The chunked SSD scan for ``impl``: the wrapper (kernel on the card,
    plain version on the CPU) or the plain version."""
    if impl == "kernel":
        return ssd_ops.mamba2_ssd
    if impl == "plain":
        return lambda *a: mamba2_ssd_chunked(*a, chunk=ssd_ops.CHUNK)
    raise ValueError(f"unknown impl {impl!r}; have {IMPLS}")


class Mamba2Block(nn.Module):
    """One Mamba2 block: RMSNorm → projections → causal conv → SSD scan →
    gated RMSNorm → output projection, added to the residual stream."""

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype, device):
        super().__init__()
        if cfg.ssm is None or cfg.ssm.kind != "mamba2":
            raise ValueError(f"{cfg.name}: Mamba2Block needs a mamba2 ssm config")
        self.cfg = cfg
        self.d_inner = cfg.ssm.expand * cfg.d_model
        self.P = cfg.ssm.head_dim
        self.H = self.d_inner // self.P
        self.N = cfg.ssm.state_dim
        self.K = cfg.ssm.conv_kernel
        self.conv_dim = self.d_inner + 2 * self.N  # x ++ B ++ C
        d, H, P, N = cfg.d_model, self.H, self.P, self.N
        f32 = torch.float32
        shapes = {
            "ln": ((d,), f32),
            "wz": ((d, H, P), dtype), "wx": ((d, H, P), dtype),
            "wB": ((d, N), dtype), "wC": ((d, N), dtype),
            "wdt": ((d, H), f32), "dt_bias": ((H,), f32),
            "A_log": ((H,), f32), "D": ((H,), f32),
            "conv_w": ((self.conv_dim, self.K), f32), "conv_b": ((self.conv_dim,), f32),
            "norm": ((H, P), f32),
            "wo": ((H, P, d), dtype),
        }
        for name, (shape, dt) in shapes.items():
            setattr(self, name, param(shape, dt, device))

    def init(self, g: torch.Generator) -> None:
        """The reference's distributions (``mamba2.py::Mamba2Block.init``)."""
        d = self.cfg.d_model
        for name in ("ln", "D", "norm"):
            getattr(self, name).data.fill_(1.0)
        for name in ("dt_bias", "A_log", "conv_b"):
            getattr(self, name).data.zero_()
        fan_in = {"wz": d, "wx": d, "wB": d, "wC": d, "wdt": d, "conv_w": self.K,
                  "wo": self.d_inner}
        for name, fi in fan_in.items():
            p = getattr(self, name)
            p.data.copy_(dense_init(g, p.shape, fi, p.dtype, p.device))

    def state_shape(self, batch: int):
        return {
            "ssm": ((batch, self.H, self.N, self.P), "float32", ("batch", "heads", None, None)),
            "conv": ((batch, self.conv_dim, self.K - 1), "float32", ("batch", None, None)),
        }

    # -- conv ------------------------------------------------------------------
    def _conv(self, full: torch.Tensor, T: int) -> torch.Tensor:
        """Depthwise causal conv over ``full`` [B, C, K-1+T] (f32) -> SiLU of
        the T outputs, [B, C, T]."""
        out = self.conv_b[None, :, None].expand(full.shape[0], -1, T)
        for j in range(self.K):
            out = out + full[:, :, j:j + T] * self.conv_w[None, :, j:j + 1]
        return F.silu(out)

    def _causal_conv_seq(self, xbc: torch.Tensor, conv_tail: torch.Tensor):
        """xbc: [B, T, conv_dim]; conv_tail: [B, conv_dim, K-1] (prior context).
        Returns (conv_out [B, T, conv_dim] in xbc's dtype, new tail)."""
        T = xbc.shape[1]
        full = torch.cat([conv_tail, xbc.float().transpose(1, 2)], dim=-1)
        out = self._conv(full, T)
        new_tail = full[:, :, full.shape[-1] - (self.K - 1):] if self.K > 1 else conv_tail
        return out.transpose(1, 2).to(xbc.dtype), new_tail

    def _causal_conv_step(self, xbc: torch.Tensor, conv_tail: torch.Tensor):
        """xbc: [B, conv_dim]; returns (out [B, conv_dim], new tail)."""
        full = torch.cat([conv_tail, xbc.float()[:, :, None]], dim=-1)  # [B, C, K]
        out = self._conv(full, 1)[:, :, 0]
        return out.to(xbc.dtype), full[:, :, 1:]

    def _project(self, x: torch.Tensor):
        """x: [..., d] -> (z, xin, B, C, dt) pre-conv projections."""
        d, H, P = self.cfg.d_model, self.H, self.P
        z = (x @ self.wz.reshape(d, H * P)).reshape(*x.shape[:-1], H, P)
        xin = (x @ self.wx.reshape(d, H * P)).reshape(*x.shape[:-1], H, P)
        Bm = x @ self.wB
        Cm = x @ self.wC
        dt = F.softplus(x.float() @ self.wdt + self.dt_bias)
        return z, xin, Bm, Cm, dt

    def _gate_out(self, x, y, z):
        y = rms_norm(y, torch.ones(self.P, device=y.device), self.cfg.rms_eps) * self.norm
        y = y.to(x.dtype) * F.silu(z.float()).to(x.dtype)
        return y.reshape(*y.shape[:-2], -1) @ self.wo.reshape(-1, self.wo.shape[-1])

    # -- forward -----------------------------------------------------------------
    def apply_seq(self, x: torch.Tensor, state: State, impl: str = "kernel"
                  ) -> Tuple[torch.Tensor, State]:
        """x: [B, T, d] (residual stream).  Returns (x_out, new state)."""
        B, T, _ = x.shape
        h = rms_norm(x, self.ln, self.cfg.rms_eps)
        z, xin, Bm, Cm, dt = self._project(h)
        xbc = torch.cat([xin.reshape(B, T, self.d_inner), Bm, Cm], dim=-1)
        conv_out, new_tail = self._causal_conv_seq(xbc, state["conv"])
        di, N = self.d_inner, self.N
        xin = conv_out[..., :di].reshape(B, T, self.H, self.P).contiguous()
        Bm = conv_out[..., di:di + N].contiguous()
        Cm = conv_out[..., di + N:].contiguous()
        A = -torch.exp(self.A_log)
        y, ssmT = ssd(impl)(xin, dt.contiguous(), A, Bm, Cm, self.D,
                            state["ssm"].contiguous())
        return x + self._gate_out(x, y, z), {"ssm": ssmT, "conv": new_tail}

    def apply_step(self, x: torch.Tensor, state: State) -> Tuple[torch.Tensor, State]:
        """x: [B, d], one token."""
        B = x.shape[0]
        h = rms_norm(x, self.ln, self.cfg.rms_eps)
        z, xin, Bm, Cm, dt = self._project(h)
        xbc = torch.cat([xin.reshape(B, self.d_inner), Bm, Cm], dim=-1)
        conv_out, new_tail = self._causal_conv_step(xbc, state["conv"])
        di, N = self.d_inner, self.N
        xin = conv_out[:, :di].reshape(B, self.H, self.P)
        Bm = conv_out[:, di:di + N]
        Cm = conv_out[:, di + N:]
        A = -torch.exp(self.A_log)
        y, ssmT = ssd_ops.mamba2_decode_step(xin, dt, A, Bm, Cm, self.D, state["ssm"])
        return x + self._gate_out(x, y, z), {"ssm": ssmT, "conv": new_tail}
