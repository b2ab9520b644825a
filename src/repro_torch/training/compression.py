"""Gradient compression with error feedback, the port of
``repro.training.compression``'s single-device half, on name-keyed dicts of
tensors (``nn.trainable``'s gradients; every leaf a tensor):

  * **int8 quantization** -- a per-tensor scale ``max|g| / 127``, round
    half to even (``torch.round``, as ``jnp.round``), the residual carried
    to the next step (EF-SGD): 1 byte an element on the wire, plus one
    scalar a tensor;
  * **top-k sparsification** -- one tensor's ``k`` largest |g| (values and
    flat indices; among equal magnitudes the lower index first, as
    ``jax.lax.top_k``), the rest accumulated locally.

Both act on gradients only (no autograd), so they compose with any
optimizer.  ``cross_pod_allreduce_compressed`` is the cross-pod all-reduce
of data-parallel gradients over a mesh's ``pod`` dim: int8 codes summed
as int32, the largest scale, dequantized, divided by the pod count, as the
reference's (which dequantizes the sum with the largest scale).
"""

from __future__ import annotations

import torch

from repro_torch.models.layers.moe import top_k_lower_index_first


def _quantize_int8(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = g.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_error_feedback(grads: dict) -> dict:
    """Zero fp32 residuals of the gradients' shapes."""
    return {k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for k, g in grads.items()}


def compress_int8(grads: dict, error: dict) -> tuple[dict, dict]:
    """``(wire, new_error)``: ``wire = {"q": int8 dict, "scale": scalar
    dict}`` of ``grads + error`` in fp32, and the residual each leaves."""
    wire: dict = {"q": {}, "scale": {}}
    new_error = {}
    for k, g in grads.items():
        target = g.float() + error[k]
        q, scale = _quantize_int8(target)
        wire["q"][k], wire["scale"][k] = q, scale
        new_error[k] = target - _dequantize_int8(q, scale)
    return wire, new_error


def decompress_int8(wire: dict) -> dict:
    return {k: _dequantize_int8(q, wire["scale"][k]) for k, q in wire["q"].items()}


def compress_topk(g: torch.Tensor, e: torch.Tensor, k_frac: float = 0.01):
    """One tensor's top-k with error feedback: ``((values, indices),
    new_error)``, ``k = max(1, int(numel * k_frac))`` of ``g + e`` by
    magnitude, the flat indices in descending order of it."""
    target = (g.float() + e).reshape(-1)
    k = max(1, int(target.numel() * k_frac))
    _, idx = top_k_lower_index_first(target.abs(), k)
    picked = target[idx]
    recon = torch.zeros_like(target).index_put_((idx,), picked)
    return (picked, idx), (target - recon).reshape(g.shape)


def decompress_topk(payload: tuple, shape: tuple) -> torch.Tensor:
    vals, idx = payload
    flat = torch.zeros(int(torch.Size(shape).numel()), dtype=torch.float32, device=vals.device)
    return flat.index_put_((idx,), vals).reshape(shape)


def wire_bytes_int8(grads: dict) -> int:
    """Bytes of an int8 wire: one an element."""
    return sum(g.numel() for g in grads.values())


def cross_pod_allreduce_compressed(grads: dict, error: dict, mesh, axis_name: str = "pod"):
    """Each rank's own gradients (plain tensors), int8-compressed with error
    feedback and averaged over the ``axis_name`` dim of ``mesh``:
    ``(mean, new_error)``.  The codes are summed as int32 and the sum is
    dequantized with the pod group's largest scale, exactly as
    ``repro.training.compression.cross_pod_allreduce_compressed``: 1 byte
    an element on the wire, plus one scalar a tensor."""
    import torch.distributed as dist

    group = mesh.get_group(axis_name)
    n = dist.get_world_size(group)
    mean, new_error = {}, {}
    for k, g in grads.items():
        target = g.float() + error[k]
        q, scale = _quantize_int8(target)
        total = q.to(torch.int32)
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        scale_max = scale.clone()
        dist.all_reduce(scale_max, op=dist.ReduceOp.MAX, group=group)
        # dequantize with the max scale (conservative, deterministic)
        mean[k] = total.float() * scale_max / n
        new_error[k] = target - _dequantize_int8(q, scale)
    return mean, new_error
