"""RG-LRU recurrent block (``repro.models.layers.rglru``: Griffin /
RecurrentGemma, arXiv:2402.19427).

The recurrence is diagonal and gated:

    r_t = sigmoid(W_a x_t + b_a)          (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)          (input gate)
    log a_t = -8 softplus(Lambda) r_t
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t x_t)

The whole Griffin recurrent block is here: ``proj_x`` -> the causal conv ->
the RG-LRU, times the tanh-GELU of ``proj_gate``, -> ``proj_out``.  The
reference runs the prefill's recurrence as ``jax.lax.associative_scan`` over
the time axis; the port runs a log-depth scan too (:func:`lru_scan`,
Hillis-Steele: 12 doubling steps at 3072 tokens), whose grouping of the
products differs from the associative scan's, so the two agree to the fp32
tolerance, not bit for bit.  Decode is one fused step.  ``lam`` starts at the
reference's ``linspace(2, 7, D)``.

From the gates through the recurrence the work runs under the tracer scope
``{name}_scan`` (a ``record_function`` range only while a profile runs),
which the card's profile reader counts as ``scan``
(``core.profiler_analysis``).  The events are the reference's: ``scan
{name}`` for the forward, ``scan {name}_step`` for a decode step.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core import tracer
from repro_torch.models.layers.basic import Dense
from repro_torch.models.layers.conv import CausalDepthwiseConv1D
from repro_torch.nn import Module, scaled_init, zeros_init

_C = 8.0


class RGLRUState(NamedTuple):
    hidden: torch.Tensor  # (B, d_rnn) recurrent state, fp32
    conv: torch.Tensor  # (B, W-1, d_rnn) conv window


def lru_scan(log_a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """h_t = exp(log_a_t) h_{t-1} + b_t along axis 1 from ``h0``: log_a, b
    (B, S, D), h0 (B, D) -> h (B, S, D).  ``h0`` folds into the first step;
    then each doubling step d = 1, 2, 4, ... combines element t with t - d
    as ``(la1 + la2, b2 + exp(la2) b1)``, ceil(log2 S) steps in all."""
    b = torch.cat([b[:, :1] + torch.exp(log_a[:, :1]) * h0[:, None], b[:, 1:]], dim=1)
    S, d = b.shape[1], 1
    while d < S:
        b = torch.cat([b[:, :d], b[:, d:] + torch.exp(log_a[:, d:]) * b[:, :-d]], dim=1)
        log_a = torch.cat([log_a[:, :d], log_a[:, d:] + log_a[:, :-d]], dim=1)
        d *= 2
    return b


def _lam_init(gen, shape, dtype):
    del gen
    # a^c = sigmoid(lam)^c spreads over (0.9, 0.999)
    return torch.linspace(2.0, 7.0, shape[0], dtype=torch.float32).to(dtype)


class RGLRUBlock(Module):
    """The Griffin recurrent block: x -> [linear -> conv1d -> RG-LRU] * gate."""

    def __init__(self, d_model: int, d_rnn: int, conv_width: int = 4, dtype=torch.float32,
                 name: str = "rglru"):
        super().__init__()
        self.d_model, self.d_rnn, self.conv_width, self.name = d_model, d_rnn, conv_width, name
        D = d_rnn
        self.proj_x = Dense(d_model, D, True, dtype, name="proj_x")
        self.proj_gate = Dense(d_model, D, True, dtype, name="proj_gate")
        self.proj_out = Dense(D, d_model, True, dtype, name="proj_out")
        self.conv = CausalDepthwiseConv1D(D, conv_width, dtype=dtype)
        self.param("w_a", (D, D), scaled_init((0,)), dtype)
        self.param("b_a", (D,), zeros_init, torch.float32)
        self.param("w_x", (D, D), scaled_init((0,)), dtype)
        self.param("b_x", (D,), zeros_init, torch.float32)
        self.param("lam", (D,), _lam_init, torch.float32)

    def _gates(self, u: torch.Tensor):
        """(log a, i) in fp32 from the conv output ``u``."""
        uf = u.float()
        r = torch.sigmoid(uf @ self.w_a.float() + self.b_a)
        i = torch.sigmoid(uf @ self.w_x.float() + self.b_x)
        return -_C * F.softplus(self.lam) * r, i

    def forward(self, x: torch.Tensor, initial_state: RGLRUState | None = None):
        """x (B, S, d_model) -> (y (B, S, d_model), the final RGLRUState)."""
        B, S, _ = x.shape
        W = self.conv_width
        gate = F.gelu(self.proj_gate(x), approximate="tanh")
        u_raw = self.proj_x(x)
        u = self.conv(u_raw)
        with tracer.scope(f"{self.name}_scan"):
            log_a, i = self._gates(u)
            b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * (i * u.float())
            h0 = (torch.zeros((B, self.d_rnn), dtype=torch.float32, device=x.device)
                  if initial_state is None else initial_state.hidden.float())
            h = lru_scan(log_a, b, h0)  # (B, S, D)
        y = self.proj_out(h.to(x.dtype) * gate)
        if tracer.active():
            tracer.record("scan", self.name, flops=8.0 * B * S * self.d_rnn,
                          bytes_hbm=tracer.nbytes(((B, S, self.d_rnn), torch.float32)) * 3,
                          seq_len=S)
        tail = u_raw[:, S - (W - 1):S] if S >= W - 1 else F.pad(u_raw, (0, 0, W - 1 - S, 0))
        return y, RGLRUState(hidden=h[:, -1], conv=tail.to(x.dtype))

    def init_state(self, batch: int) -> RGLRUState:
        """Zero states beside the weights."""
        dev = self.lam.device
        return RGLRUState(
            hidden=torch.zeros((batch, self.d_rnn), dtype=torch.float32, device=dev),
            conv=torch.zeros((batch, self.conv_width - 1, self.d_rnn),
                             dtype=self.proj_x.kernel.dtype, device=dev))

    def step(self, x: torch.Tensor, state: RGLRUState):
        """x (B, 1, d_model), one decode step -> (y (B, 1, d_model), state)."""
        B = x.shape[0]
        gate = F.gelu(self.proj_gate(x), approximate="tanh")[:, 0]
        u, conv_state = self.conv.step(self.proj_x(x)[:, 0], state.conv)
        with tracer.scope(f"{self.name}_scan"):
            log_a, i = self._gates(u)
            a = torch.exp(log_a)
            h = a * state.hidden + torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (
                i * u.float())
        y = self.proj_out((h.to(x.dtype) * gate)[:, None, :])
        if tracer.active():
            tracer.record("scan", f"{self.name}_step", flops=8.0 * B * self.d_rnn,
                          bytes_hbm=tracer.nbytes(((B, self.d_rnn), torch.float32)) * 2,
                          seq_len=1)
        return y, RGLRUState(hidden=h, conv=conv_state)
