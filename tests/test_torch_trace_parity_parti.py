"""The port's full-width event stream of Parti (bf16, 21.9 B parameters, on
``meta``) equals the JAX reference's event for event: the text encoder, 8
decode steps at sampled cache lengths scaled to the 1024 tokens, and the
VQ-GAN decoder."""

from torch_trace_oracle import assert_streams_equal, port_events, reference_events


def test_event_stream_equals_the_reference():
    assert_streams_equal(port_events("parti", "auto"), reference_events("parti", "auto"))
