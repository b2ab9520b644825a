"""Training entry point of the port, the port of ``repro.launch.train``:

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b --reduced \\
        --device cpu --steps 20                  # CPU-sized smoke
    python -m repro_torch.launch.train --arch olmo-1b --batch 2 --seq 2048 --steps 4

Builds the LM from a seed on the device (the card unless ``--device cpu``),
then runs the fault-tolerant microbatched loop (``training.trainer``) on
the deterministic data pipeline with the model's loss on the kernel tier.
``--ckpt-dir`` holds the checkpoints; a directory that already has one
resumes from it.

``--mesh`` builds a mesh (``debug``: the whole world on ``data``;
``pod16x16`` / ``pod2x16x16``: the production meshes, 256 / 512 ranks),
``--profile`` picks the sharding rules (``2d``: FSDP + TP, ``fsdp``: ZeRO-3
over the grid, ``serve``), and the model's leaves are sharded by them.
Every rank runs the loop (SPMD, under ``torchrun``, or a world of one
in-process); rank 0 logs and writes the checkpoints.  Without ``--mesh``
the run is mesh-free (no process group):

    torchrun --nproc_per_node 4 -m repro_torch.launch.train --arch olmo-1b --reduced \
        --device cpu --steps 4 --profile fsdp
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.data import SyntheticLMData
from repro_torch.launch.mesh import init_world, make_debug_mesh, make_production_mesh
from repro_torch.models.transformer import TransformerLM
from repro_torch.nn import init_module, specs_of
from repro_torch.parallel import sharding as shlib
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.trainer import TrainConfig, train
from repro_torch.workload.base import resolve_device

MESHES = ("debug", "pod16x16", "pod2x16x16")


def _quiet(*_args, **_kw) -> None:
    """The log of a rank other than 0."""


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--reduced", action="store_true", help="tiny same-family config (CPU)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--mesh", default=None, choices=MESHES,
                    help="shard over a mesh (debug: the whole world on data); "
                         "default: mesh-free, no process group")
    ap.add_argument("--profile", default="2d", choices=("2d", "fsdp", "serve"))
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train_ckpt"))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None, *, log=print, mark=None):
    """Train as the arguments say; returns (model, state, loss history).
    ``mark`` is the trainer's step hook (``make_accumulating_step``)."""
    args = parse_args(argv)
    shlib.set_profile(args.profile)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    device = resolve_device(args.device)
    mesh = None
    try:
        if args.mesh == "debug":
            _, world = init_world(device)
            mesh = make_debug_mesh(world, 1, device=device)
        elif args.mesh is not None:
            mesh = make_production_mesh(multi_pod=args.mesh == "pod2x16x16", device=device)
    except ValueError as e:
        raise SystemExit(f"--mesh {args.mesh}: {e}")
    model = init_module(TransformerLM(cfg), 0, device)
    if mesh is not None:
        if torch.distributed.get_rank() != 0:
            log = _quiet
        model = shlib.shard_params_tree(model, specs_of(model), mesh)
    data = SyntheticLMData(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch)

    def loss_fn(batch, gen):
        del gen  # the LM's loss draws no noise
        return model.loss(batch)

    tcfg = TrainConfig(total_steps=args.steps, microbatches=args.microbatches,
                       checkpoint_dir=args.ckpt_dir,
                       opt=AdamWConfig(lr=1e-3, total_steps=args.steps))
    state, history = train(model, loss_fn, data, tcfg, device=device, log=log, mark=mark,
                           mesh=mesh)
    if history:
        log(f"final loss {history[-1]:.4f} (start {history[0]:.4f}, {len(history)} steps)")
    return model, state, history


if __name__ == "__main__":
    main()
