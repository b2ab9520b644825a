"""The port's full-width event streams of the MoE assigned LMs
(``deepseek-moe-16b``, ``qwen3-moe-30b-a3b``) equal the JAX reference's,
event for event (``auto``): the LM recipe (a 2048-token prefill, then 4
sampled decode steps), with each MoE layer's ``moe_experts`` and
``moe_dispatch`` events (and deepseek's ``moe_shared``), the prefill's
capacity (``ceil(T k / E * 1.25)``) and the decode's ``no_drop`` one, and
qwen3's qk-norm events.  The streams are traced on ``meta``."""

import pytest

from torch_trace_oracle import assert_streams_equal, port_events, reference_events


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "qwen3-moe-30b-a3b"])
def test_event_stream_equals_the_reference(arch):
    got = port_events(arch, "auto")
    assert_streams_equal(got, reference_events(arch, "auto"))
    ops = [e.op for e in got]
    n_moe = {"deepseek-moe-16b": 27, "qwen3-moe-30b-a3b": 48}[arch]
    # one dispatch event a MoE layer in the prefill and in each of the 4 decode samples
    assert ops.count("dispatch") == 5 * n_moe
    names = {e.name.split("/")[-1] for e in got}
    assert ("moe_shared" in names) == (arch == "deepseek-moe-16b")
    dispatch = next(e for e in got if e.op == "dispatch")
    assert dispatch.seq_len is None and dispatch.name.startswith("prefill/")
