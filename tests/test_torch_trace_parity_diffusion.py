"""The port's full-width event streams of Stable Diffusion (bf16) and
Make-A-Video equal the JAX reference's, event for event, on the fused
(``auto``) path and on the two the paper's Flash-Attention speedup compares
(``naive``, ``blocked_jax``).  Both packages trace abstractly: the port on
``meta``, the reference under ``jax.eval_shape``."""

import pytest

from torch_trace_oracle import assert_streams_equal, port_events, reference_events

CASES = [(arch, impl) for arch in ("stable-diffusion", "make-a-video")
         for impl in ("auto", "naive", "blocked_jax")]


@pytest.mark.parametrize("arch,impl", CASES)
def test_event_stream_equals_the_reference(arch, impl):
    assert_streams_equal(port_events(arch, impl), reference_events(arch, impl))
