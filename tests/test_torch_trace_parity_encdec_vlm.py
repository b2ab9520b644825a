"""The port's full-width event streams of the enc-dec and VLM families equal
the JAX reference's, event for event (``auto``, traced as
``tests/torch_trace_oracle.py`` traces the suite: the reference abstractly
with its backend answering ``tpu``, the port on ``meta``).

whisper-base is traced at the model level, because the reference's
``LMWorkload.trace_events`` cannot trace it (its prefill has no frame
embeddings): a prefill of 2 x 1500 frames (whisper's 30-second window) and
``dec_len_for(1500)`` = 187 decoder tokens, then a decode step at position
187 against the context.  qwen2-vl-2b is traced through ``trace_events``
(token prompts), and with a prefill on 2 x 2048 embeddings with M-RoPE
streams.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config as j_get_config
from repro.core import characterize as j_characterize
from repro.workload import workload_for as j_workload_for
from repro_torch.configs import get_config
from repro_torch.core import characterize
from repro_torch.launch.steps import dec_len_for
from repro_torch.workload import workload_for
from torch_trace_oracle import assert_streams_equal, port_events, reference_events

B, FRAMES = 2, 1500


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _reference(arch: str, prefill_kw: dict, decode=None) -> tuple:
    """The reference's prefill (and decode step) events, traced abstractly
    with its backend answering ``tpu`` (``auto`` resolves to Pallas)."""
    model = j_workload_for(j_get_config(arch)).model
    params = j_characterize.abstract_params(model)
    with mock.patch.object(jax, "default_backend", lambda: "tpu"):
        pre = j_characterize.trace_workload(
            lambda p, kw: model.prefill(p, **kw, impl="auto", max_len=prefill_kw["max_len"]),
            params, {k: v for k, v in prefill_kw.items() if k != "max_len"})
        dec = None if decode is None else decode(model, params)
    return pre, dec


def test_whisper_prefill_and_decode_step_streams_equal_the_reference():
    S = dec_len_for(get_config("whisper-base"), FRAMES)
    enc = jax.ShapeDtypeStruct((B, FRAMES, 512), jnp.float32)

    def j_decode(model, params):
        caches = jax.eval_shape(lambda: model.init_cache(B, S + 1))
        return j_characterize.trace_workload(
            lambda p, t, c, x: model.decode_step(p, t, c, jnp.int32(S), context=x, impl="auto"),
            params, jax.ShapeDtypeStruct((B, 1), jnp.int32), caches, enc)

    want_pre, want_dec = _reference("whisper-base", dict(
        tokens=jax.ShapeDtypeStruct((B, S), jnp.int32), enc_embeds=enc, max_len=S + 1),
        j_decode)
    model = workload_for(get_config("whisper-base")).model
    got_pre = characterize.trace_workload(
        lambda t, e: model.prefill(t, enc_embeds=e, impl="auto", max_len=S + 1),
        _meta((B, S), torch.int64), _meta((B, FRAMES, 512)))
    got_dec = characterize.trace_workload(
        lambda t, x: model.decode_step(t, model.init_cache(B, S + 1), S, context=x, impl="auto"),
        _meta((B, 1), torch.int64), _meta((B, FRAMES, 512)))
    assert all(p.device.type == "meta" for p in model.parameters())
    assert_streams_equal(got_pre, want_pre)
    assert_streams_equal(got_dec, want_dec)
    # 6 encoder, 6 causal self- and 6 cross-attention calls in the prefill
    attn = [(e.name, e.seq_len) for e in got_pre if e.op == "attention"]
    assert len(attn) == 18
    assert sum(n.startswith("enc") for n, _ in attn) == 6
    assert sum(n.endswith("cross_attn") and s == FRAMES for n, s in attn) == 6
    # the enc-dec step has no layer scope; it projects each layer's cross K/V
    assert not any(e.name.startswith("layer_") for e in got_dec)
    assert [e.name for e in got_dec[:3]] == ["embed", "wk", "wv"]


def test_qwen2_vl_streams_equal_the_reference():
    """``trace_events`` (a 2048-token prompt, then 4 sampled decode steps)
    and a prefill on 2 x 2048 embeddings with (3, B, S) M-RoPE streams."""
    assert_streams_equal(port_events("qwen2-vl-2b", "auto"),
                         reference_events("qwen2-vl-2b", "auto"))
    S = 2048
    want, _ = _reference("qwen2-vl-2b", dict(
        embeds=jax.ShapeDtypeStruct((B, S, 1536), jnp.float32),
        mrope_positions=jax.ShapeDtypeStruct((3, B, S), jnp.int32), max_len=S + 16))
    model = workload_for(get_config("qwen2-vl-2b")).model
    got = characterize.trace_workload(
        lambda e, m: model.prefill(embeds=e, mrope_positions=m, impl="auto", max_len=S + 16),
        _meta((B, S, 1536)), _meta((3, B, S), torch.int32))
    assert_streams_equal(got, want)
    assert not any(e.op == "embed" for e in got)  # embeddings go in as they are
