"""Training entry point of the port, the port of ``repro.launch.train``:

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b --reduced \\
        --device cpu --steps 20                  # CPU-sized smoke
    python -m repro_torch.launch.train --arch olmo-1b --batch 2 --seq 2048 --steps 4

Builds the LM from a seed on the device (the card unless ``--device cpu``),
then runs the fault-tolerant microbatched loop (``training.trainer``) on
the deterministic data pipeline with the model's loss on the kernel tier.
``--ckpt-dir`` holds the checkpoints; a directory that already has one
resumes from it.  A ``--mesh`` other than ``debug`` or a sharding
``--profile`` other than the default raise: sharded training comes with
the multi-GPU slice.
"""

from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.configs import get_config, reduced
from repro_torch.data import SyntheticLMData
from repro_torch.models.transformer import TransformerLM
from repro_torch.nn import init_module
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.trainer import TrainConfig, train
from repro_torch.workload.base import resolve_device

MESHES = ("debug", "pod16x16", "pod2x16x16")


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--reduced", action="store_true", help="tiny same-family config (CPU)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--mesh", default="debug", choices=MESHES)
    ap.add_argument("--profile", default="2d")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train_ckpt"))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None, *, log=print, mark=None):
    """Train as the arguments say; returns (model, state, loss history).
    ``mark`` is the trainer's step hook (``make_accumulating_step``)."""
    args = parse_args(argv)
    if args.mesh != "debug" or args.profile != "2d":
        raise SystemExit(f"--mesh {args.mesh} / --profile {args.profile}: sharded training is "
                         f"not ported yet (it comes with the multi-GPU slice)")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    device = resolve_device(args.device)
    model = init_module(TransformerLM(cfg), 0, device)
    data = SyntheticLMData(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch)

    def loss_fn(batch, gen):
        del gen  # the LM's loss draws no noise
        return model.loss(batch)

    tcfg = TrainConfig(total_steps=args.steps, microbatches=args.microbatches,
                       checkpoint_dir=args.ckpt_dir,
                       opt=AdamWConfig(lr=1e-3, total_steps=args.steps))
    state, history = train(model, loss_fn, data, tcfg, device=device, log=log, mark=mark)
    if history:
        log(f"final loss {history[-1]:.4f} (start {history[0]:.4f}, {len(history)} steps)")
    return model, state, history


if __name__ == "__main__":
    main()
