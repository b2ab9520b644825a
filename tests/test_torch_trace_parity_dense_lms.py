"""The port's full-width event streams of the dense assigned LMs equal the
JAX reference's, event for event (``auto``): the LM recipe (a 2048-token
prefill, then 4 sampled decode steps), with OLMo's tied head recorded as
``embed_logits`` and no ``lm_head`` event.  ``qwen2-72b`` (80 layers, the
longest reference trace) has a file of its own,
``tests/test_torch_trace_parity_qwen2.py``."""

import pytest

from torch_trace_oracle import assert_streams_equal, port_events, reference_events


@pytest.mark.parametrize("arch", ["olmo-1b", "stablelm-3b", "glm4-9b"])
def test_event_stream_equals_the_reference(arch):
    got = port_events(arch, "auto")
    assert_streams_equal(got, reference_events(arch, "auto"))
    names = {e.name.split("/")[-1] for e in got}
    if arch == "olmo-1b":  # the tied head
        assert "embed_logits" in names and "lm_head" not in names
    else:
        assert "lm_head" in names and "embed_logits" not in names
