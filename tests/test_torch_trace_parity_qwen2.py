"""The port's full-width event stream of ``qwen2-72b`` (80 layers, 72.7 B
parameters: it fits no single card, so it is traced on ``meta`` only)
equals the JAX reference's, event for event (``auto``)."""

from torch_trace_oracle import assert_streams_equal, port_events, reference_events


def test_event_stream_equals_the_reference():
    got = port_events("qwen2-72b", "auto")
    assert_streams_equal(got, reference_events("qwen2-72b", "auto"))
    assert sum(e.op == "attention" for e in got if e.name.startswith("prefill/")) == 80
