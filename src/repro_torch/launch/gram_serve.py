"""Gram service driver: batched multi-tenant A^tA over a mixed-size trace.

    PYTHONPATH=src python -m repro_torch.launch.gram_serve --requests 64 --slots 4

The port of ``repro/launch/gram_serve.py``: the same flags and the same
output, plus ``--device`` (the card by default; ``--device cpu`` runs the
engine on the CPU).

Generates a heterogeneous request trace (log-uniform shapes), optionally
pre-autotunes each bucket, serves it through ``gram.GramEngine`` and
prints throughput, latency percentiles and the recompile count.

Robustness drills ride the same driver: ``--faults`` arms a
``runtime.faults`` profile (or set ``REPRO_FAULTS`` in the environment),
``--verify`` picks the output-guard level, and the retry/deadline knobs
map straight onto the engine's degradation ladder — e.g.

    ... --faults "poison_output:rate=0.1;exec_fail:rate=0.05" --verify 2

The overload model rides it as well (DESIGN.md §15): ``--async`` serves
through the background scheduler (``submit`` returns futures; the driver
drains them), ``--tenants N`` spreads the trace round-robin over N
synthetic tenants, and the admission knobs (``--max-queue``,
``--admission shed|block``, ``--tenant-quota``, ``--tenant-weights``)
bound the queues — shed requests fail fast with ``Overloaded`` and are
reported separately from served/failed.

The flight recorder rides along too (DESIGN.md §14): ``--trace-out``
enables request-scoped tracing and writes the Chrome trace-event JSON
(open it in Perfetto — every request's submit -> queue-wait -> execute ->
verify -> done chain, with fault firings, guard vetoes and rung
transitions as instants on the same timeline; a ``.jsonl`` sidecar holds
the grep-friendly form), ``--metrics-out`` writes the Prometheus-style
registry snapshot, and ``--drift-theta`` sets the cost-model drift band
(findings print at exit and land in ``stats()["drift"]``; the port feeds
its wall channel only).
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np

from ..gram import GramEngine, autotune_bucket, bucket_shape
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from ..runtime import faults


def make_trace(rng, requests: int, min_dim: int, max_dim: int):
    """Log-uniform (m, n) request shapes — small Grams dominate, a few
    big ones stress the bucketing, like real mixed tenant traffic."""
    lo, hi = np.log2(min_dim), np.log2(max_dim)
    shapes = []
    for _ in range(requests):
        m = int(round(2 ** rng.uniform(lo, hi)))
        n = int(round(2 ** rng.uniform(lo, hi)))
        shapes.append((m, n))
    return shapes


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--levels", default="1")
    ap.add_argument("--mode", default="auto",
                    choices=("auto", "fused", "reference"))
    ap.add_argument("--min-dim", type=int, default=16)
    ap.add_argument("--max-dim", type=int, default=256)
    ap.add_argument("--min-bucket", type=int, default=32)
    ap.add_argument("--autotune", action="store_true",
                    help="pre-autotune every bucket in the trace "
                         "(measured, persists winners)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--faults", default=None, metavar="PROFILE",
                    help="fault-injection profile, e.g. "
                         "'poison_output:rate=0.1;exec_fail:rate=0.05' "
                         "(see repro_torch.runtime.faults)")
    ap.add_argument("--verify", default="finite",
                    help="output guards: 'off', 'finite' (NaN/Inf + "
                         "diagonal scan, default) or an int K (finite "
                         "scan + K Freivalds probes per result)")
    ap.add_argument("--retries", type=int, default=3,
                    help="max executable retries per batch before the "
                         "batch is failed")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request deadline (requests past it fail "
                         "fast instead of retrying)")
    ap.add_argument("--backoff-ms", type=float, default=0.0,
                    help="base retry backoff (doubles per attempt)")
    ap.add_argument("--max-backoff-ms", type=float, default=5000.0,
                    help="hard cap on one retry backoff sleep — bounds "
                         "deadline-less requests too")
    ap.add_argument("--async", dest="async_serve", action="store_true",
                    help="serve through the background scheduler loop: "
                         "submit() returns futures, the driver drains "
                         "them (DESIGN.md §15)")
    ap.add_argument("--tenants", type=int, default=1,
                    help="spread the trace round-robin over N synthetic "
                         "tenants (t0..tN-1) for the weighted-fair "
                         "scheduler")
    ap.add_argument("--tenant-weights", default=None, metavar="SPEC",
                    help="per-tenant WFQ weights, e.g. 't0=3,t1=1' "
                         "(unlisted tenants weigh 1)")
    ap.add_argument("--tenant-quota", type=int, default=None,
                    help="max queued requests per tenant (excess is "
                         "shed with Overloaded)")
    ap.add_argument("--tenant-max-inflight", type=int, default=None,
                    help="max in-flight requests per tenant per batch")
    ap.add_argument("--max-queue", type=int, default=1024,
                    help="global admission bound across all buckets")
    ap.add_argument("--max-queue-per-bucket", type=int, default=None,
                    help="admission bound per shape bucket")
    ap.add_argument("--admission", default="shed",
                    choices=("shed", "block"),
                    help="on a full queue: shed fast with Overloaded "
                         "(default) or block the submitter until space "
                         "frees / --block-timeout-ms expires")
    ap.add_argument("--block-timeout-ms", type=float, default=1000.0,
                    help="admission='block' gives up (sheds) after this")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="enable request-scoped tracing and write the "
                         "Chrome trace-event JSON here (Perfetto-"
                         "loadable; a .jsonl sidecar is written too)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the Prometheus-style metrics snapshot "
                         "here at exit")
    ap.add_argument("--drift-theta", type=float, default=2.0,
                    help="cost-model drift band: flag buckets whose "
                         "measured/predicted ratio leaves "
                         "[1/theta, theta]")
    ap.add_argument("--device", default=None,
                    help="where the engine runs: the card by default, or "
                         "'cpu'")
    args = ap.parse_args(argv)
    levels = args.levels if args.levels == "auto" else int(args.levels)
    verify = args.verify if args.verify in ("off", "finite") \
        else int(args.verify)

    rng = np.random.default_rng(args.seed)
    shapes = make_trace(rng, args.requests, args.min_dim, args.max_dim)

    if args.autotune:
        for M, N in sorted({bucket_shape(m, n, min_side=args.min_bucket)
                            for m, n in shapes}):
            entry = autotune_bucket(M, N, measure=True,
                                    min_side=args.min_bucket,
                                    device=args.device)
            print(f"[autotune] {M}x{N}: {entry['mode']} levels="
                  f"{entry['levels']} bk={entry['bk']} ({entry['source']})")

    if args.faults:
        faults.install(faults.parse_profile(args.faults, seed=args.seed))
    if args.trace_out:
        obs_trace.set_tracer(obs_trace.Tracer(enabled=True))

    weights = {}
    if args.tenant_weights:
        for part in args.tenant_weights.split(","):
            name, _, w = part.partition("=")
            weights[name.strip()] = float(w)

    eng = GramEngine(slots=args.slots, levels=levels, mode=args.mode,
                     min_bucket=args.min_bucket, verify=verify,
                     max_retries=args.retries,
                     backoff_s=args.backoff_ms / 1e3,
                     max_backoff_s=args.max_backoff_ms / 1e3,
                     drift_theta=args.drift_theta,
                     max_queue=args.max_queue,
                     max_queue_per_bucket=args.max_queue_per_bucket,
                     admission=args.admission,
                     block_timeout_s=args.block_timeout_ms / 1e3,
                     tenant_weights=weights or None,
                     tenant_quota=args.tenant_quota,
                     tenant_max_inflight=args.tenant_max_inflight,
                     device=args.device)
    deadline = None if args.deadline_ms is None else args.deadline_ms / 1e3
    if args.async_serve:
        eng.start()
    t0 = time.perf_counter()
    futures = []
    n_tenants = max(args.tenants, 1)
    for i, (m, n) in enumerate(shapes):
        futures.append(
            eng.submit(rng.standard_normal((m, n)).astype(np.float32),
                       deadline_s=deadline, tenant=f"t{i % n_tenants}"))
    finished = eng.run_to_completion()
    dt = time.perf_counter() - t0
    if args.async_serve:
        eng.shutdown()
    s = eng.stats()
    terminal = sum(1 for f in futures if f.done())
    print(f"served {len(finished)} gram requests in {dt:.2f}s "
          f"({max(len(finished), 1)/dt:.1f} req/s) over {s['ticks']} ticks"
          + (f" [async scheduler, {terminal}/{len(futures)} futures "
             f"terminal]" if args.async_serve else ""))
    print(f"buckets={len(s['buckets'])} compiles={s['compile_count']} "
          f"p50={s['p50_latency_s']*1e3:.1f}ms "
          f"p99={s['p99_latency_s']*1e3:.1f}ms")
    if s["shed"] or s["deadline_missed"] or s["cancelled"]:
        print(f"shed={s['shed']} deadline_missed={s['deadline_missed']} "
              f"cancelled={s['cancelled']} queue_peak={s['queue_peak']} "
              f"admission={s['admission']['mode']}")
    if args.tenants > 1:
        for name, ts in s["tenants"].items():
            print(f"  tenant {name}: submitted={ts['submitted']} "
                  f"served={ts['served']} shed={ts['shed']} "
                  f"failed={ts['failed']} weight={ts['weight']:g}")
    if args.faults or s["failed"] or s["retries"]:
        print(f"ok={s['served']} failed={s['failed']} "
              f"degraded={s['degraded_served']} retries={s['retries']} "
              f"guard_vetoes={s['guard_failures']} "
              f"injected={faults.active().count('poison_output') + faults.active().count('exec_fail')}")
    for f in s["drift"]:
        print(f"[drift] {f['key']}: measured/predicted ratio "
              f"{f['ratio']:.2f} outside [1/{f['theta']:g}, {f['theta']:g}] "
              f"over {f['n']} samples — autotune winner suspect")
    if args.trace_out:
        tracer = obs_trace.get_tracer()
        out = Path(args.trace_out)
        out.parent.mkdir(parents=True, exist_ok=True)
        tracer.write_chrome_trace(out)
        tracer.write_jsonl(out.with_suffix(".jsonl"))
        print(f"[trace] {len(tracer)} events -> {out} "
              f"(+ {out.with_suffix('.jsonl').name}; "
              f"dropped={tracer.dropped})")
        obs_trace.set_tracer(None)
    if args.metrics_out:
        out = Path(args.metrics_out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(obs_metrics.render_prometheus())
        out.with_suffix(".drift.json").write_text(
            json.dumps(eng.drift.snapshot(), indent=1))
        print(f"[metrics] registry snapshot -> {out} "
              f"(+ {out.with_suffix('.drift.json').name})")
    if args.faults:
        faults.reset()
    return s


if __name__ == "__main__":
    main()
