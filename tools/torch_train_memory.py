"""The tensors a train forward of the PyTorch/CUDA port saves for its
backward, counted on the ``meta`` device (no memory, no card: a few seconds
to a minute on the CPU for the full-width models).

    PYTHONPATH=src python tools/torch_train_memory.py [ARCH ...]

For each model (default: make-a-video, phenaki, muse, parti) it builds the
full-width config on ``meta``, turns every leaf on, and runs one forward of
the loss ``chip_smoke.py``'s phase 9 checks at step 1 (Make-A-Video one
microbatch of 1 video of 16 frames with 16 text tokens; Phenaki 2 x 2816
tokens, Muse 2 x 256 and Parti on 4 of its 80 layers 2 x 1024, text at the
served prompt length) on the ``kernel`` and ``torch`` tiers under a
``saved_tensors_hooks`` that sums the bytes of each distinct storage saved.
It prints one line a model and tier: the parameters, the saved bytes, and
the saved bytes less the parameters' (the activations, taking every weight
as saved by its matmul).  The peak of a step on the card adds the
parameters, gradients and moments, and whatever the backward allocates.
"""

import dataclasses
import sys

import torch

from repro_torch.configs.suite import MAKE_A_VIDEO, MUSE, PARTI, PHENAKI
from repro_torch.workload import workload_for

PARTI_TRAIN_LAYERS = 4  # as chip_smoke.py


def _batches(meta="meta") -> dict:
    """Per model: (config, the loss of one forward, given the model and an impl)."""
    zeros = dict(device=meta, dtype=torch.long)
    parti = dataclasses.replace(PARTI, n_layers=PARTI_TRAIN_LAYERS)
    return {
        "make-a-video": (MAKE_A_VIDEO, lambda m, impl: m.denoise_loss(
            {"video": torch.zeros(1, 16, 64, 64, 4, device=meta),
             "text": torch.zeros(1, 16, **zeros)},
            torch.zeros(1, **zeros), torch.zeros(1, 16, 64, 64, 4, device=meta), impl=impl)),
        "phenaki": (PHENAKI, lambda m, impl: m.masked_loss(
            {"video_tokens": torch.zeros(2, 2816, **zeros), "text": torch.zeros(2, 77, **zeros)},
            torch.zeros(2, 2816, dtype=torch.bool, device=meta), impl=impl)),
        "muse": (MUSE, lambda m, impl: m.token_loss(
            {"image_tokens": torch.zeros(2, 256, **zeros), "text": torch.zeros(2, 77, **zeros)},
            torch.zeros(2, 256, dtype=torch.bool, device=meta), impl=impl)),
        "parti": (parti, lambda m, impl: m.token_loss(
            {"image_tokens": torch.zeros(2, 1024, **zeros), "text": torch.zeros(2, 128, **zeros)},
            None, impl=impl)),
    }


def saved_gib(fn) -> float:
    """GiB of the distinct storages ``fn()`` saves for its backward."""
    seen = {}

    def pack(t):
        st = t.untyped_storage()
        seen[st._cdata] = (st.nbytes(), t)  # the tensor kept: no id is reused
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn()
    return sum(n for n, _ in seen.values()) / 2**30


def main(archs) -> None:
    models = _batches()
    for arch in archs or models:
        cfg, loss = models[arch]
        model = workload_for(cfg).model
        for p in model.parameters():
            p.requires_grad_(True)
        params = sum(p.numel() * p.element_size() for p in model.parameters()) / 2**30
        for impl in ("kernel", "torch"):
            saved = saved_gib(lambda: loss(model, impl))
            print(f"{arch} {impl}: params {params:.2f} GiB, saved {saved:.2f} GiB, "
                  f"saved less params {saved - params:.2f} GiB", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
