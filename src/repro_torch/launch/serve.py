"""Serving launcher (the embedding mode of ``repro/launch/serve.py``).

Drives the paper's title scenario: an `OnlineEmbeddingEngine` serving
Zipfian embedding lookups from a `TieredHKVTable` behind a
`TablePublisher`, with an `OnlineTrainer` interleaving streaming updates
(the §3.5 reader/updater/inserter triple under live eviction).  It runs on
the card; `--device cpu` is the only way onto the CPU, and without a card
and without that flag it raises:

  PYTHONPATH=src python -m repro_torch.launch.serve --smoke \\
      --waves 16 --wave-size 256 --miss-policy admit
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --smoke --maintain

`--arrival` picks the request-size process (steady | burst | diurnal) and
`--admission continuous` turns on continuous-batch admission; the summary
then reports the per-request queue-wait / service / total p50-p99 split.

`--mode lm` runs the LM prefill and greedy decode loop over random prompts
(the reference's flags; `--smoke` is the arch's reduced config, without
it the published widths, in bfloat16):

  PYTHONPATH=src python -m repro_torch.launch.serve --mode lm --arch qwen2-0.5b \
      --smoke --batch 4 --prompt-len 32 --decode-steps 16 --device cpu
"""

from __future__ import annotations

import argparse
import sys


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=("embedding", "lm"), default="embedding")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the plain PyTorch path on the CPU; default: the card")
    # embedding mode
    ap.add_argument("--hot-capacity", type=int, default=16 * 128)
    ap.add_argument("--cold-capacity", type=int, default=128 * 128)
    ap.add_argument("--dim", type=int, default=16)
    ap.add_argument("--wave-size", type=int, default=1024)
    ap.add_argument("--waves", type=int, default=64)
    ap.add_argument("--miss-policy", choices=("readonly", "admit"), default="admit")
    ap.add_argument("--no-promote", action="store_true",
                    help="readonly waves stay pure readers (no tiered miss-path promotion)")
    ap.add_argument("--zipf-alpha", type=float, default=1.05)
    ap.add_argument("--maintain", action="store_true",
                    help="run the MaintenanceScheduler between waves (watermark rebalance)")
    ap.add_argument("--sweep-budget", type=int, default=512,
                    help="max structural moves per maintenance step")
    ap.add_argument("--maintain-every", type=int, default=1,
                    help="waves between maintenance steps")
    ap.add_argument("--update-read-ratio", type=float, default=0.25,
                    help="trainer steps per served wave")
    ap.add_argument("--arrival", choices=("steady", "burst", "diurnal"), default="steady",
                    help="request-size process per tick (data.synthetic arrival "
                         "generators); steady submits exactly one wave-sized request a tick")
    ap.add_argument("--admission", choices=("wave", "continuous"), default="wave",
                    help="wave-granular admission or continuous batching (splice into "
                         "partially drained staging, waves dispatched as they fill)")
    ap.add_argument("--host-budget-ms", type=float, default=None,
                    help="between-wave host slack budget (ms) that staging and "
                         "maintenance compete for; default cadence-only maintenance")
    # observability (repro_torch.obs)
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome trace-event JSON (Perfetto-loadable) of the "
                         "serve run's span timeline")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the end-of-run MetricsRegistry snapshot in Prometheus "
                         "text exposition format")
    # lm mode
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--decode-steps", type=int, default=16)
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.mode == "lm":
        lm_main(args)
    else:
        embedding_main(args)
    return 0


def lm_main(args):
    """Prefill `--batch` random prompts of `--prompt-len` tokens, then
    `--decode-steps` greedy tokens a lane (the first from the prefill's
    logits); prints the rate and the first sequence, returns the generated
    tokens [batch, decode_steps] as numpy."""
    import time

    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core.table import resolve_device

    device = resolve_device(args.device)
    arch = get_arch(args.arch)
    model = arch.model(smoke=args.smoke)
    lm = arch.smoke if args.smoke else arch.lm
    params = model.init(torch.Generator(device=device).manual_seed(args.seed), device=device)

    rng = np.random.default_rng(args.seed)
    prompts = torch.from_numpy(
        rng.integers(0, lm.vocab, size=(args.batch, args.prompt_len)).astype(np.int32)).to(device)
    max_len = args.prompt_len + args.decode_steps

    t0 = time.perf_counter()
    logits, state = model.prefill(params, prompts, max_len=max_len)
    toks = logits.argmax(dim=-1).to(torch.int32)
    out = [toks]
    for _ in range(args.decode_steps - 1):
        logits, state = model.decode_step(params, toks, state)
        toks = logits.argmax(dim=-1).to(torch.int32)
        out.append(toks)
    gen = torch.stack(out, dim=1).cpu().numpy()   # waits for the card
    dt = time.perf_counter() - t0
    print(f"[serve] {args.arch}: generated {gen.shape} tokens in {dt:.2f}s "
          f"({args.batch * args.decode_steps / dt:.1f} tok/s)")
    print("first sequence:", gen[0].tolist())
    return gen


def embedding_main(args):
    from repro_torch.obs import Tracer, install

    if args.smoke:
        args.hot_capacity = min(args.hot_capacity, 4 * 128)
        args.cold_capacity = min(args.cold_capacity, 16 * 128)
        args.wave_size = min(args.wave_size, 256)
        args.waves = min(args.waves, 12)

    # with --trace-out the table ops', closure stages' and kernel launches'
    # spans land in the same file as the serving stack's
    tracer = Tracer() if args.trace_out else None
    with install(tracer):
        return _serve_embedding(args, tracer)


def _serve_embedding(args, tracer):
    import numpy as np
    import torch

    from repro_torch.core.tiered import TieredHKVTable
    from repro_torch.data import arrival_sizes, zipf_keys
    from repro_torch.serving import (EmbeddingRequest, OnlineEmbeddingEngine,
                                     OnlineTrainer, TablePublisher)

    table = TieredHKVTable.create(hot_capacity=args.hot_capacity,
                                  cold_capacity=args.cold_capacity, dim=args.dim,
                                  device=args.device)
    pub = TablePublisher(table, tracer=tracer)
    trainer = OnlineTrainer(publisher=pub, publish_every=1)
    sched = None
    if args.maintain:
        from repro_torch.maintenance import MaintenancePolicy, MaintenanceScheduler

        sched = MaintenanceScheduler(MaintenancePolicy(
            every_waves=args.maintain_every, sweep_budget=args.sweep_budget), tracer=tracer)
    eng = OnlineEmbeddingEngine(
        pub, wave_size=args.wave_size, miss_policy=args.miss_policy,
        promote=not args.no_promote, scheduler=sched, admission=args.admission,
        host_budget_s=(args.host_budget_ms / 1e3 if args.host_budget_ms is not None else None),
        tracer=tracer)

    serve_rng = np.random.default_rng(args.seed)
    train_rng = np.random.default_rng(args.seed + 1)
    key_space = 2 * args.cold_capacity
    grads = torch.ones((args.wave_size, args.dim), dtype=torch.float32, device=table.device)

    # per-tick arrivals: 'steady' keeps one wave-sized request a tick;
    # 'burst'/'diurnal' modulate the offered key count, so the queue builds
    # and drains (the SLO split below reports it)
    sizes = arrival_sizes(args.arrival, np.random.default_rng(args.seed + 2),
                          args.waves, args.wave_size,
                          **({"base_load": 1.0} if args.arrival == "steady" else {}))
    due = 0.0
    for i, sz in enumerate(sizes):
        eng.submit(EmbeddingRequest(
            rid=i, keys=zipf_keys(serve_rng, int(sz), args.zipf_alpha, key_space)))
        r = eng.step()
        due += args.update_read_ratio
        while due >= 1.0:
            trainer.train_step(
                zipf_keys(train_rng, args.wave_size, args.zipf_alpha, key_space), grads)
            due -= 1.0
        if r is not None and (i + 1) % max(args.waves // 4, 1) == 0:
            print(f"[serve] wave {i+1:4d}: hit={r.hit_rate*100:5.1f}% "
                  f"kv/s={r.kv_per_s/1e3:.1f}k v{r.table_version}")
    eng.run_until_drained()
    m = eng.metrics()
    print(f"[serve] {m.waves} waves, {m.keys} keys: hit={m.hit_rate*100:.1f}% "
          f"hot={m.hot_rate*100:.1f}% kv/s={m.kv_per_s/1e3:.1f}k "
          f"p50={m.p50_latency_s*1e3:.1f}ms p99={m.p99_latency_s*1e3:.1f}ms "
          f"published={pub.published} offered={pub.offered}")
    print(f"[serve] SLO ({args.admission} admission, {args.arrival} arrivals): "
          f"{m.requests} requests, "
          f"queue-wait p50={m.p50_queue_wait_s*1e3:.1f}ms "
          f"p99={m.p99_queue_wait_s*1e3:.1f}ms | "
          f"service p50={m.p50_service_s*1e3:.1f}ms p99={m.p99_service_s*1e3:.1f}ms | "
          f"total p50={m.p50_total_s*1e3:.1f}ms p99={m.p99_total_s*1e3:.1f}ms")
    if sched is not None:
        t = sched.totals
        print(f"[serve] maintenance: {t.runs} steps, demoted={t.demoted} "
              f"dropped={t.dropped} deferred={t.deferred} "
              f"time={t.time_s*1e3:.0f}ms; "
              f"reactive demotions/wave={m.demotions_per_wave:.1f}")
    # end-of-run table occupancy (TableStats, the state half of the
    # observability story; the wave counters above are the runtime half)
    hot_stats, cold_stats = pub.table.tier_stats()
    print(f"[serve] table: hot {int(hot_stats.size)}/{hot_stats.capacity} "
          f"(lf={float(hot_stats.load_factor):.2f}) | "
          f"cold {int(cold_stats.size)}/{cold_stats.capacity} "
          f"(lf={float(cold_stats.load_factor):.2f})")
    if args.trace_out or args.metrics_out:
        from repro_torch.obs import MetricsRegistry

        reg = MetricsRegistry()
        reg.observe_engine(m)
        if sched is not None:
            reg.observe_maintenance(sched.totals)
        reg.observe_table(hot_stats, tier="hot")
        reg.observe_table(cold_stats, tier="cold")
        if args.metrics_out:
            reg.save(args.metrics_out, format="prometheus")
            print(f"[serve] metrics snapshot ({len(reg)} gauges) -> {args.metrics_out}")
        if args.trace_out:
            tracer.save(args.trace_out)
            print(f"[serve] trace ({len(tracer)} events) -> {args.trace_out}")
    return m


if __name__ == "__main__":
    sys.exit(main())
