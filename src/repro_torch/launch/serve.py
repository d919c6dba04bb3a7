"""Serving driver: batched KV-cache engine over a reduced-config model.

``python -m repro_torch.launch.serve --arch qwen2.5-3b --requests 8``

The port of ``repro/launch/serve.py``: the same flags and the same
output, plus ``--device`` (the card by default; ``--device cpu`` runs
on the CPU).
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from ..configs.registry import ARCHS, reduced_arch
from ..models import init_params
from ..runtime.serving import ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default="qwen2.5-3b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request deadline: requests still waiting "
                         "past it fail fast (status='deadline')")
    ap.add_argument("--tenants", type=int, default=1,
                    help="spread requests round-robin over N synthetic "
                         "tenants (SLO accounting rides the requests)")
    ap.add_argument("--priority-every", type=int, default=0, metavar="K",
                    help="mark every K-th request priority=1 (admitted "
                         "ahead of the FIFO order); 0 disables")
    ap.add_argument("--device", default=None,
                    help="where the model runs: the card by default, or "
                         "'cpu'")
    args = ap.parse_args(argv)

    cfg = reduced_arch(args.arch)
    params = init_params(cfg, args.seed, device=args.device)
    eng = ServingEngine(cfg, params, slots=args.slots, max_seq=args.max_seq,
                        temperature=args.temperature, seed=args.seed,
                        device=args.device)
    rng = np.random.default_rng(args.seed)
    deadline = None if args.deadline_ms is None else args.deadline_ms / 1e3
    for i in range(args.requests):
        plen = int(rng.integers(4, 24))
        prompt = rng.integers(0, cfg.vocab_size, size=plen).tolist()
        eng.add_request(prompt, max_new_tokens=args.max_new,
                        deadline_s=deadline,
                        tenant=f"t{i % max(args.tenants, 1)}",
                        priority=1 if (args.priority_every
                                       and i % args.priority_every == 0)
                        else 0)
    t0 = time.perf_counter()
    finished = eng.run_to_completion()
    dt = time.perf_counter() - t0
    toks = sum(len(r.generated) for r in finished)
    expired = sum(1 for r in finished if r.status == "deadline")
    print(f"served {len(finished)} requests, {toks} tokens "
          f"in {dt:.2f}s ({toks/dt:.1f} tok/s)"
          + (f", {expired} expired on deadline" if expired else ""))
    for r in finished[:4]:
        print(f"  req {r.uid}: prompt[{len(r.prompt)}] -> {r.generated}")
    return finished


if __name__ == "__main__":
    main()
