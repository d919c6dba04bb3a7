"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

The port of ``repro/launch/train.py``: the same flags and the same
output, plus ``--device`` (the card by default; ``--device cpu`` trains
on the CPU).  ``--reduced`` runs the smoke-scale config of the same
family.  The checkpoints go under ``--workdir`` (by default a directory
in the temporary directory, ``TMPDIR``).
"""
from __future__ import annotations

import argparse
import logging
import os
import tempfile

from ..configs.base import TrainConfig
from ..configs.registry import ARCHS, get_arch, reduced_arch
from ..data.pipeline import DataConfig
from ..runtime.trainer import FailureInjector, Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config of the same family")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optimizer", choices=("adamw", "shampoo"),
                    default="adamw")
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--workdir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train"))
    ap.add_argument("--fail-at", type=int, default=-1,
                    help="inject a simulated failure at this step")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="where the model trains: the card by default, or "
                         "'cpu'")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    cfg = reduced_arch(args.arch) if args.reduced else get_arch(args.arch)
    tc = TrainConfig(learning_rate=args.lr, total_steps=args.steps,
                     warmup_steps=max(args.steps // 10, 1),
                     optimizer=args.optimizer, microbatch=args.microbatch,
                     checkpoint_every=args.checkpoint_every, seed=args.seed)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                    global_batch=args.batch, seed=args.seed,
                    enc_seq=cfg.encoder_seq if cfg.family == "audio" else 0,
                    enc_dim=cfg.d_model if cfg.family == "audio" else 0)
    trainer = Trainer(cfg, tc, dc, args.workdir,
                      failure=FailureInjector(args.fail_at),
                      device=args.device)
    hist = trainer.run(args.steps)
    first, last = hist[0]["loss"], hist[-1]["loss"]
    print(f"steps={len(hist)} loss {first:.4f} -> {last:.4f} "
          f"(stragglers flagged: {len(trainer.watchdog.flagged)})")
    return hist


if __name__ == "__main__":
    main()
