"""Mamba-2 mixer (``repro.models.layers.ssm``): the chunked SSD algorithm
(state-space duality, arXiv:2405.21060) and its one-token decode step.

Within a chunk of ``chunk`` tokens the recurrence is expanded into an
attention-like quadratic form: batched products over (chunk, chunk) decay
and score matrices.  Across chunks a Python loop over the ``S / chunk``
chunks (8 at 2048 tokens) carries the (heads, head_dim, state) recurrent
state, as the reference's ``lax.scan``.  The reference computes all of it
in ``jnp`` einsums outside any Pallas kernel; here they are ``torch.matmul``
in the (batch, chunk, head, row, column) layout, and the three-operand
``bclsh,bclsh,bcshp->bclhp`` contracts ``G * L`` first, so that no
(B, nc, L, L, H, P) tensor is formed.  Decode updates the state once per
token.

The inits are the reference's deterministic ones: ``A_log = log(linspace(1,
16, H))``, ``dt_bias`` zeros and ``D`` ones.  On a mesh the chunked
operands are pinned head-parallel (heads over ``model``), as the
reference's ``constrain`` calls pin them.

From the softplus of ``dt`` through the ``D`` skip, the work runs under the
tracer scope ``{name}_scan`` (a ``record_function`` range only while a
profile runs): the card's profile reader counts the device time launched
there as ``scan`` (``core.profiler_analysis``).  The events are the
reference's: ``scan {name}`` for the forward, ``scan {name}_step`` for a
decode step, beside the projections', the conv's and the norm's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core import tracer
from repro_torch.models.layers.basic import Dense
from repro_torch.models.layers.conv import CausalDepthwiseConv1D
from repro_torch.models.layers.norms import RMSNorm
from repro_torch.nn import Module, ones_init, zeros_init
from repro_torch.parallel.sharding import constrain


class Mamba2State(NamedTuple):
    ssm: torch.Tensor  # (B, H, P, N) recurrent state, fp32
    conv: torch.Tensor  # (B, W-1, conv_dim) conv window


def _a_log_init(gen, shape, dtype):
    del gen
    return torch.log(torch.linspace(1.0, 16.0, shape[0], dtype=torch.float32)).to(dtype)


class Mamba2Mixer(Module):
    def __init__(self, d_model: int, d_state: int = 128, d_conv: int = 4, expand: int = 2,
                 head_dim: int = 64, chunk: int = 256, n_groups: int = 1,
                 dtype=torch.float32, name: str = "mamba2"):
        super().__init__()
        self.d_model, self.d_state, self.d_conv = d_model, d_state, d_conv
        self.head_dim, self.chunk, self.n_groups, self.name = head_dim, chunk, n_groups, name
        self.d_inner = expand * d_model
        self.n_heads = self.d_inner // head_dim
        self.conv_dim = self.d_inner + 2 * n_groups * d_state
        d_in_proj = 2 * self.d_inner + 2 * n_groups * d_state + self.n_heads
        H = self.n_heads
        self.in_proj = Dense(d_model, d_in_proj, False, dtype, name="in_proj",
                             axes=("embed", "mlp"))
        self.conv = CausalDepthwiseConv1D(self.conv_dim, d_conv, dtype=dtype)
        self.param("dt_bias", (H,), zeros_init, torch.float32)
        self.param("A_log", (H,), _a_log_init, torch.float32)
        self.param("D", (H,), ones_init, torch.float32)
        self.norm = RMSNorm(self.d_inner, dtype=dtype, name="ssm_norm")
        self.out_proj = Dense(self.d_inner, d_model, False, dtype, name="out_proj",
                              axes=("mlp", "embed"))

    def _split(self, zxbcdt: torch.Tensor):
        di = self.d_inner
        return (zxbcdt[..., :di], zxbcdt[..., di:di + self.conv_dim],
                zxbcdt[..., di + self.conv_dim:])

    def _split_xbc(self, xbc: torch.Tensor):
        di, gn = self.d_inner, self.n_groups * self.d_state
        return xbc[..., :di], xbc[..., di:di + gn], xbc[..., di + gn:]

    def _heads(self, m: torch.Tensor) -> torch.Tensor:
        """(..., n_groups * N) -> (..., H, N): each group over its heads."""
        m = m.reshape(*m.shape[:-1], self.n_groups, self.d_state)
        return m.repeat_interleave(self.n_heads // self.n_groups, dim=-2)

    def forward(self, u: torch.Tensor, initial_state: Mamba2State | None = None):
        """u (B, S, d_model) -> (y (B, S, d_model), the final Mamba2State)."""
        B, S, _ = u.shape
        H, P, N, L, W = self.n_heads, self.head_dim, self.d_state, self.chunk, self.d_conv
        z, xbc_raw, dt = self._split(self.in_proj(u))
        x, Bm, Cm = self._split_xbc(F.silu(self.conv(xbc_raw)))
        x = x.reshape(B, S, H, P)
        Bm, Cm = self._heads(Bm), self._heads(Cm)  # (B, S, H, N)
        pad = (-S) % L
        nc = (S + pad) // L
        with tracer.scope(f"{self.name}_scan"):
            dt = F.softplus(dt.float() + self.dt_bias)  # (B, S, H)
            dA = dt * -torch.exp(self.A_log)
            if pad:
                x, Bm, Cm = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, Bm, Cm))
                dA, dt = (F.pad(t, (0, 0, 0, pad)) for t in (dA, dt))

            def chunks(t):  # (B, nc*L, H, K) -> (B, nc, H, L, K), fp32
                return t.reshape(B, nc, L, H, t.shape[-1]).permute(0, 1, 3, 2, 4).float()

            # head-parallel SSD: the (L, L) decay/score tensors, the memory
            # hot-spot, stay O(H / tp) a rank
            xc, Bc, Cc = (constrain(chunks(t), ("batch", None, "model", None, None))
                          for t in (x, Bm, Cm))
            cs = torch.cumsum(constrain(dA.reshape(B, nc, L, H).permute(0, 1, 3, 2),
                                        ("batch", None, "model", None)), dim=-1)  # (B,nc,H,L)
            # the decay matrix L[i, j] = exp(cs_i - cs_j) for j <= i, masked
            # before the exp: the upper triangle's exponents are positive
            causal = torch.ones((L, L), dtype=torch.bool, device=u.device).tril()
            lmat = torch.exp(torch.where(causal, cs[..., :, None] - cs[..., None, :], -1e30))
            x_dt = xc * dt.reshape(B, nc, L, H).permute(0, 1, 3, 2)[..., None]  # (B,nc,H,L,P)
            # y_diag[i] = sum_j L[i, j] (C_i . B_j) x_dt[j], G * L first
            y = torch.matmul(torch.matmul(Cc, Bc.transpose(-1, -2)) * lmat, x_dt)
            # each chunk's final state: sum_j exp(cs_last - cs_j) x_dt[j] B_j^T
            decay = torch.exp(cs[..., -1:] - cs)  # (B, nc, H, L)
            states = torch.matmul((x_dt * decay[..., None]).transpose(-1, -2), Bc)  # (B,nc,H,P,N)
            # the recurrence across chunks: the state entering each chunk
            chunk_decay = torch.exp(cs[..., -1])  # (B, nc, H)
            st = (torch.zeros((B, H, P, N), dtype=torch.float32, device=u.device)
                  if initial_state is None else initial_state.ssm.float())
            prev = []
            for c in range(nc):
                prev.append(st)
                st = st * chunk_decay[:, c, :, None, None] + states[:, c]
            prev_states = torch.stack(prev, dim=1)  # (B, nc, H, P, N)
            # the entering state's part: y_off[l] = exp(cs_l) C_l . state
            y = y + torch.matmul(Cc, prev_states.transpose(-1, -2)) * torch.exp(cs)[..., None]
            y = y.permute(0, 1, 3, 2, 4).reshape(B, nc * L, H, P)[:, :S]
            y = y + x[:, :S] * self.D[:, None]
        y = y.reshape(B, S, self.d_inner).to(u.dtype)
        # the gated RMSNorm (Mamba-2: norm(y * silu(z)))
        out = self.out_proj(self.norm(y * F.silu(z)))
        if tracer.active():
            tracer.record(
                "scan", self.name,
                flops=(2.0 * B * nc * L * L * H * (N + P)  # G and y_diag
                       + 2.0 * B * nc * L * H * P * N * 2),  # states and y_off
                bytes_hbm=tracer.nbytes(((B, nc, L, H, P), torch.float32)) * 3
                + tracer.nbytes(((B, nc, H, P, N), torch.float32)) * 2,
                seq_len=S)
        # the last W-1 raw conv inputs, so that decode continues seamlessly
        tail = (xbc_raw[:, S - (W - 1):S] if S >= W - 1
                else F.pad(xbc_raw, (0, 0, W - 1 - S, 0)))
        return out, Mamba2State(ssm=st, conv=tail.to(u.dtype))

    def init_state(self, batch: int) -> Mamba2State:
        """Zero states beside the weights."""
        dev = self.dt_bias.device
        return Mamba2State(
            ssm=torch.zeros((batch, self.n_heads, self.head_dim, self.d_state),
                            dtype=torch.float32, device=dev),
            conv=torch.zeros((batch, self.d_conv - 1, self.conv_dim),
                             dtype=self.in_proj.kernel.dtype, device=dev))

    def step(self, u: torch.Tensor, state: Mamba2State):
        """Single-token decode: u (B, 1, d_model) -> (y (B, 1, d_model), state)."""
        B = u.shape[0]
        H, P, N = self.n_heads, self.head_dim, self.d_state
        z, xbc, dt = self._split(self.in_proj(u)[:, 0])
        conv_out, conv_state = self.conv.step(xbc, state.conv)
        x, Bm, Cm = self._split_xbc(F.silu(conv_out))
        with tracer.scope(f"{self.name}_scan"):
            x = x.reshape(B, H, P).float()
            Bm, Cm = self._heads(Bm).float(), self._heads(Cm).float()  # (B, H, N)
            dt = F.softplus(dt.float() + self.dt_bias)  # (B, H)
            decay = torch.exp(dt * -torch.exp(self.A_log))
            ssm = (state.ssm * decay[:, :, None, None]
                   + (x * dt[..., None])[..., None] * Bm[:, :, None, :])
            y = torch.matmul(ssm, Cm[..., None])[..., 0] + x * self.D[:, None]
        y = y.reshape(B, 1, self.d_inner).to(u.dtype)
        out = self.out_proj(self.norm(y * F.silu(z[:, None, :])))
        if tracer.active():
            tracer.record("scan", f"{self.name}_step", flops=2.0 * B * H * P * N * 2,
                          bytes_hbm=tracer.nbytes((state.ssm.shape, torch.float32)) * 2,
                          seq_len=1)
        return out, Mamba2State(ssm=ssm, conv=conv_state)
