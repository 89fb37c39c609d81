#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py              # from the repository root, one card

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` with nvcc for
sm_90a (first use), then runs three phases; any failure exits non-zero:

1. kernel vs plain, at the main path's shapes: on a table of the paper's
   config B (2^27 slots, dim 32, float32 values, dual bucket, LRU) filled
   to λ 0.5 and then 1.0, each kernel's wrapper and its plain PyTorch
   version run on the same inputs and must agree bit for bit (tolerance:
   exact equality, as the slice is integer maths and float copies).  Both
   are timed there with CUDA events, beside one PyTorch library call where
   one computes the same function, and beside the kernel's bound (the
   larger of its bytes over the HBM rate and its operations over the
   int32 rate, both counted from this run's inputs).
2. kernel path vs plain path: a reduced table (2^20 slots, 65,536-key
   batches) is driven past λ = 1.0 through the public insert_or_assign and
   find on both backends; statuses, find results and the full state must be
   equal after every op.
3. the main path at config B's full size, with the launch counts set to 0
   just before and read just after: insert_or_assign in 1,048,576-key
   batches to λ 0.5, 1.0, and past it (the last batches must report EVICTED
   and REJECTED); find on resident keys and on a mix with misses, checked
   against the keys the script knows are resident; throughput of both ops,
   median of timed runs, at λ 0.5 and 1.0.

The last two lines are a JSON object with one entry per kernel, and the
JSON result line.  Without a card (or without the repository around it)
the script exits non-zero and prints no result.  ``--rehearse`` runs the
same phases at a tiny size on the CPU through the plain versions, to check
the script itself; it never prints a result and exits non-zero.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM published HBM3 rate
# 32-bit integer operations a second outside the tensor cores: the data
# sheet's 67 TFLOP/s float32 counts 128 lanes x 2 (an FMA) a clock on each
# SM; the CUDA programming guide gives compute capability 9.0 64 results a
# clock an SM for 32-bit integer add, compare, min and max: a quarter.
INT32_OPS_PER_S = 67e12 / 4
# int32 operations of one unsigned 64-bit compare or equality test, and of
# one compare under the victim order (occupied, score, key, slot): six
# 32-bit words in one carry chain
OPS_U64_CMP = 2
OPS_VICTIM_CMP = 6
SEED = 20260417
STATUS_NAMES = ("invalid", "updated", "inserted", "evicted", "rejected")


@dataclasses.dataclass(frozen=True)
class Sizes:
    capacity: int            # config B slots (phases 1 and 3)
    batch: int               # keys per insert_or_assign / find
    small_capacity: int      # phase 2
    small_batch: int
    hot_keys: int            # keys aimed at one bucket, to force rejections
    timed_runs: int


FULL = Sizes(capacity=2**27, batch=2**20, small_capacity=2**20, small_batch=2**16,
             hot_keys=1024, timed_runs=5)
TINY = Sizes(capacity=2**12, batch=2**9, small_capacity=2**11, small_batch=2**9,
             hot_keys=400, timed_runs=2)
DIM = 32


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    """A check that holds under ``python -O`` too."""
    if not cond:
        raise AssertionError(msg)


def main(argv: list[str]) -> int:
    rehearse = "--rehearse" in argv
    import torch

    if not rehearse and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one GPU", file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable ({e}); run from the repository root",
              file=sys.stderr)
        return 2
    smoke = Smoke(torch.device("cpu") if rehearse else torch.device("cuda"),
                  TINY if rehearse else FULL)
    smoke.run()
    if rehearse:
        log("chip_smoke: rehearsal on the CPU finished; no result is printed")
        return 3
    print(json.dumps({"kernels": smoke.kernel_rows()}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


class Smoke:
    def __init__(self, device, sizes: Sizes):
        import torch

        from repro_torch.core import find as find_mod
        from repro_torch.core import u64
        from repro_torch.kernels import _build, find_scan, scatter, upsert_scan

        self.torch, self.dev, self.sz = torch, device, sizes
        self.find_mod, self.u64, self._build = find_mod, u64, _build
        self.fs, self.us, self.sc = find_scan, upsert_scan, scatter
        self.gen = torch.Generator(device=device).manual_seed(SEED)
        self.next_key = 1
        self.stats: dict[str, dict] = {}      # per kernel: errors, timings, bounds
        self.launches: dict[str, int] = {}

    # ------------------------------------------------------------------ utils

    def sync(self):
        if self.dev.type == "cuda":
            self.torch.cuda.synchronize()

    def fresh_keys(self, n: int):
        """n keys never issued before, in [0, 2^63): an odd multiplier and
        an offset modulo 2^63 are a bijection, so distinct counters give
        distinct keys.  (A negative int64 id is padding at the API.)"""
        torch = self.torch
        idx = torch.arange(self.next_key, self.next_key + n, device=self.dev)
        self.next_key += n
        return (idx * 0x2545F4914F6CDD1D + 0x1D8E4E27C47D124F) & (2**63 - 1)

    def values(self, n: int):
        return self.torch.randn((n, DIM), generator=self.gen, device=self.dev)

    def time_ms(self, fn, runs: int, warmup: int = 1) -> float:
        """Median of `runs` timed calls (CUDA events on the card)."""
        torch = self.torch
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(runs):
            self.sync()
            if self.dev.type == "cuda":
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                fn()
                b.record()
                b.synchronize()
                times.append(a.elapsed_time(b))
            else:
                t0 = time.perf_counter()
                fn()
                times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    def hot_bucket_keys(self, num_buckets: int, n: int, bucket: int):
        """n fresh keys whose primary bucket is `bucket`, built by inverting
        the fmix32 finalizer: h1 = fmix32(fmix32(hi ^ GOLDEN) ^ lo) is chosen
        with its low bits equal to `bucket`, and lo solved for."""
        torch, u64 = self.torch, self.u64
        m = u64.MASK32

        def unxorshift(h, s):
            x = h
            for _ in range(32 // s + 1):
                x = h ^ (x >> s)
            return x & m

        def fmix32_inv(h):
            h = unxorshift(h, 16)
            h = (h * pow(0xC2B2AE35, -1, 2**32)) & m
            h = unxorshift(h, 13)
            h = (h * pow(0x85EBCA6B, -1, 2**32)) & m
            return unxorshift(h, 16)

        bucket %= num_buckets
        j = torch.arange(n, device=self.dev)
        h1 = (bucket + j * num_buckets) & m
        hi = (0x5EED0000 + j + self.next_key) & m
        self.next_key += n
        a = u64.fmix32(hi ^ 0x9E3779B9)
        keys = u64.join(hi, fmix32_inv(h1) ^ a)
        h1_check, _ = u64.hash_pair(keys)
        require(bool((u64.bucket_from_hash(h1_check, num_buckets) == bucket).all()),
                "hot keys missed their bucket")
        return keys

    def record(self, name: str, **kw):
        self.stats.setdefault(name, {}).update(kw)

    def check_equal(self, name: str, got, want, ctx: str) -> None:
        """Kernel outputs against the plain version's: bit-identical."""
        torch = self.torch
        for i, (g, w) in enumerate(zip(got, want)):
            if g.dtype != w.dtype or g.shape != w.shape:
                raise AssertionError(f"{name} {ctx}: output {i} is {g.dtype}{tuple(g.shape)}, "
                                     f"plain gives {w.dtype}{tuple(w.shape)}")
            if not torch.equal(g, w):
                ne = g != w
                diff = (g[ne].double() - w[ne].double()).abs().max().item()
                raise AssertionError(f"{name} {ctx}: output {i} differs from the plain "
                                     f"version in {int(ne.sum())} elements (max abs diff {diff})")
        # equal outputs: the largest absolute difference is 0
        self.record(name, max_abs_err=0.0)
        self.stats[name].setdefault("checks", []).append(ctx)

    # ----------------------------------------------------------------- phases

    def run(self):
        torch = self.torch
        log(f"chip_smoke: python {sys.version.split()[0]} torch {torch.__version__} "
            f"cuda {torch.version.cuda} device {self.dev}"
            + (f" ({torch.cuda.get_device_name(0)})" if self.dev.type == "cuda" else ""))
        if self.dev.type == "cuda":
            t0 = time.perf_counter()
            lib = self._build.build()
            self._build.library()
            log(f"build: {lib.name} in {time.perf_counter() - t0:.1f} s")
            for entry in self._build.build_log:
                for line in entry.splitlines():
                    if "registers" in line or line.startswith("[nvcc") or "spill" in line:
                        log("  " + line.strip())
        t0 = time.perf_counter()
        self.phase_kernels()
        log(f"phase 1 (kernel vs plain at config B shapes) passed in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        self.phase_paths()
        log(f"phase 2 (kernel path vs plain path) passed in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        self.phase_main()
        log(f"phase 3 (main path at config B) passed in {time.perf_counter() - t0:.1f} s")
        self.report()

    def config_b(self, backend="auto"):
        from repro_torch import HKVTable

        return HKVTable.create(capacity=self.sz.capacity, dim=DIM, buckets_per_key=2,
                               score_policy="lru", device=self.dev, backend=backend)

    def fill(self, table, target: float):
        """insert_or_assign fresh batches until the load factor reaches
        `target`; returns the last batch's keys, values and statuses."""
        keys = vals = status = None
        for _ in range(2 * table.capacity // self.sz.batch + 8):
            if table.load_factor() >= target:
                break
            keys, vals = self.fresh_keys(self.sz.batch), self.values(self.sz.batch)
            status = table.insert_or_assign(keys, vals).status
        require(table.load_factor() >= target, f"the table did not reach λ = {target}")
        return keys, vals, status

    # phase 1 --------------------------------------------------------------

    def phase_kernels(self):
        torch = self.torch
        table = self.config_b()
        resident = self.fill(table, 0.5)[0]
        for lam in (0.5, 1.0):
            if lam == 1.0:
                resident = self.fill(table, 1.0)[0]
            log(f"phase 1: λ = {table.load_factor():.6f}")
            self.compare_kernels(table, resident, lam)
        del table
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def compare_kernels(self, table, resident, lam: float):
        torch, sz = self.torch, self.sz
        st, cfg = table.state, table.cfg
        n, b, s = sz.batch, cfg.num_buckets, cfg.slots_per_bucket
        runs, tag = sz.timed_runs, f"λ={lam}"
        # queries as find sees them: half resident, half fresh, some EMPTY
        q = torch.cat([resident[: n // 2], self.fresh_keys(n - n // 2)])
        q = q[torch.randperm(n, generator=self.gen, device=self.dev)]
        q[:: 97] = self.u64.EMPTY
        p = self.find_mod.probe_keys(cfg, q)
        planes = (st.digests, st.keys, st.scores)

        # find_scan
        args = (*planes, st.values, p.bucket1, p.bucket2, p.digest, q)
        got, want = self.fs.find_scan(*args), self.fs.find_scan_plain(*args)
        self.check_equal("find_scan", got, want, tag)
        self.record("find_scan", **{f"ms@{lam}": self.time_ms(lambda: self.fs.find_scan(*args), runs),
                                    f"plain_ms@{lam}": self.time_ms(lambda: self.fs.find_scan_plain(*args), 2),
                                    **self.find_work(st, p, q, want, lam)})

        # upsert_probe: the locate pass, and the select pass (zero queries)
        args = (*planes, p.bucket1, p.bucket2, p.digest, q)
        self.check_equal("upsert_probe", self.us.upsert_probe(*args),
                         self.us.upsert_probe_plain(*args), tag + " locate")
        zargs = (*planes, p.bucket1, p.bucket2, torch.zeros_like(p.digest), torch.zeros_like(q))
        self.check_equal("upsert_probe", self.us.upsert_probe(*zargs),
                         self.us.upsert_probe_plain(*zargs), tag + " select")
        # least work: every key and score of both rows (occupancy and the
        # minimum need them all, and the full-key match then needs no
        # digest), read once a distinct row; per slot an occupancy test, a
        # minimum step and a key equality, each one unsigned 64-bit compare
        rows = torch.unique(torch.cat([p.bucket1, p.bucket2])).numel()
        self.record("upsert_probe", **{
            f"ms@{lam}": self.time_ms(lambda: self.us.upsert_probe(*args), runs),
            f"plain_ms@{lam}": self.time_ms(lambda: self.us.upsert_probe_plain(*args), 2),
            f"bytes@{lam}": rows * 16 * s + n * (4 + 4 + 8) + n * 16,
            f"ops@{lam}": 2 * n * s * 3 * OPS_U64_CMP})

        # claim_scan: target buckets with small canonical ranks, and the full range
        buckets = torch.randint(0, b, (n,), generator=self.gen, device=self.dev)
        rank = torch.randint(0, 3, (n,), generator=self.gen, device=self.dev)
        rank[::8] = torch.randint(0, s, (rank[::8].numel(),), generator=self.gen, device=self.dev)
        args = (st.keys, st.scores, buckets, rank)
        self.check_equal("claim_scan", self.us.claim_scan(*args), self.us.claim_scan_plain(*args), tag)
        # least work: the keys and scores of each distinct row once; and a
        # selection of rank r among s slots makes at least s - 1 compares
        # (the compare graph must connect them), each under the victim
        # order.  The kernel itself makes s * s, 128 times that: its time
        # is checked against its compare loop by rerunning it with every
        # query on one row, whose bytes then come from cache.
        rows = torch.unique(buckets).numel()
        one_row = (st.keys, st.scores, torch.full_like(buckets, int(buckets[0])), rank)
        self.record("claim_scan", **{
            f"ms@{lam}": self.time_ms(lambda: self.us.claim_scan(*args), runs),
            f"ms_one_row@{lam}": self.time_ms(lambda: self.us.claim_scan(*one_row), runs),
            f"plain_ms@{lam}": self.time_ms(lambda: self.us.claim_scan_plain(*args), 2),
            f"bytes@{lam}": rows * 16 * s + n * (4 + 4) + n * 24,
            f"ops@{lam}": n * (s - 1) * OPS_VICTIM_CMP,
            f"loop_ops@{lam}": n * s * s * OPS_VICTIM_CMP})

        # scatter_rows, set and add, on a copy of the value plane each
        r_tot = st.values.shape[0]
        rows_i = torch.randperm(r_tot, generator=self.gen, device=self.dev)[:n]
        mask = torch.rand(n, generator=self.gen, device=self.dev) < 0.9
        rows_i[~mask] = torch.where(torch.arange(n, device=self.dev)[~mask] % 2 == 0,
                                    rows_i[mask][0], r_tot + 5)   # must not write
        upd = self.values(n)
        for add in (False, True):
            vk = st.values
            vp = st.values.clone()
            self.sc.scatter_rows(vk, rows_i, upd, mask, add)
            self.sc.scatter_rows_plain(vp, rows_i, upd, mask, add)
            self.check_equal("scatter_rows", (vk,), (vp,), tag + (" add" if add else " set"))
            del vp
        rows_m, upd_m = rows_i[mask], upd[mask]
        vp = st.values
        m = int(mask.sum())
        self.record("scatter_rows", **{
            f"ms@{lam}": self.time_ms(lambda: self.sc.scatter_rows(vp, rows_i, upd, mask, False), runs),
            f"plain_ms@{lam}": self.time_ms(
                lambda: self.sc.scatter_rows_plain(vp, rows_i, upd, mask, False), 2),
            f"library_ms@{lam}": self.time_ms(lambda: vp.index_put_((rows_m,), upd_m), runs),
            f"bytes@{lam}": n * (4 + 1) + m * DIM * 4 * 2, f"ops@{lam}": 0})
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def find_work(self, st, p, q, plain_out, lam) -> dict:
        """Least bytes and operations of find_scan on these queries.  Bytes:
        the query inputs (4-byte bucket indices); the digest line of every
        probed row (none for an EMPTY key, bucket2 only after a miss in
        bucket1); the keys whose digest matched; the score and value row of
        each hit; and the outputs.  Operations: 128 digest bytes a probed
        row, four to a 32-bit compare, and one 64-bit equality a candidate."""
        torch = self.torch
        found, sel = plain_out[0].bool(), plain_out[1].bool()
        n, v = q.shape[0], st.values.shape[1]
        valid = q != self.u64.EMPTY
        second = valid & ~(found & ~sel) & (p.bucket2 != p.bucket1)   # probed after bucket1
        probed_b = torch.cat([p.bucket1[valid], p.bucket2[second]])
        probed_q = torch.cat([torch.nonzero(valid).flatten(), torch.nonzero(second).flatten()])
        cand = int((st.digests[probed_b] == p.digest[probed_q][:, None]).sum())
        rows = torch.unique(probed_b).numel()
        hits = int(found.sum())
        return {f"bytes@{lam}": (n * (4 + 4 + 1 + 8) + rows * 128 + cand * 8 + hits * (8 + v * 4)
                                 + n * (4 + 4 + 4 + 8 + v * 4)),
                f"ops@{lam}": probed_b.numel() * 128 // 4 + cand * OPS_U64_CMP}

    # phase 2 --------------------------------------------------------------

    def phase_paths(self):
        from repro_torch import HKVTable

        torch, sz = self.torch, self.sz
        for policy in ("lru", "lfu"):
            kw = dict(capacity=sz.small_capacity, dim=DIM, buckets_per_key=2,
                      score_policy=policy, device=self.dev)
            tk = HKVTable.create(backend="auto", **kw)
            tp = HKVTable.create(backend="plain", **kw)
            n = sz.small_batch
            space = self.fresh_keys(2 * sz.small_capacity)
            seen = set()
            for step in range(3 * sz.small_capacity // n // 2 + 8):
                keys = space[torch.randint(0, space.numel(), (n,), generator=self.gen,
                                           device=self.dev)]
                keys[::61] = self.u64.EMPTY
                if step % 4 == 3:   # a burst aimed at one bucket
                    keys[: sz.hot_keys] = self.hot_bucket_keys(tk.cfg.num_buckets, sz.hot_keys, step)
                vals = self.values(n)
                sk = tk.insert_or_assign(keys, vals).status
                sp = tp.insert_or_assign(keys, vals).status
                self.assert_same(sk, sp, f"{policy} step {step} status")
                fk, fp = tk.find(keys), tp.find(keys)
                for name in ("values", "found", "scores"):
                    self.assert_same(getattr(fk, name), getattr(fp, name), f"{policy} step {step} find.{name}")
                for name in ("keys", "digests", "scores", "values"):
                    self.assert_same(getattr(tk.state, name), getattr(tp.state, name),
                                     f"{policy} step {step} state.{name}")
                require((tk.state.clock, tk.state.epoch) == (tp.state.clock, tp.state.epoch),
                        f"{policy} step {step}: clocks differ")
                seen.update(torch.unique(sk).tolist())
            log(f"phase 2 {policy}: {step + 1} ops, λ = {tk.load_factor():.4f}, statuses seen "
                f"{sorted(STATUS_NAMES[i] for i in seen)}")
            require({3, 4} <= seen, "phase 2 did not reach eviction and rejection")
            del tk, tp

    def assert_same(self, a, b, ctx):
        require(self.torch.equal(a, b), f"kernel path and plain path differ: {ctx}")

    # phase 3 --------------------------------------------------------------

    def phase_main(self):
        torch, sz = self.torch, self.sz
        self._build.reset_counts()
        table = self.config_b()
        n = sz.batch
        log(f"phase 3: config B table, capacity {table.capacity}, dim {table.dim}, "
            f"dual bucket, lru, on {table.device}")
        self.throughput = {}
        for lam in (0.5, 1.0):
            keys, vals, status = self.fill(table, lam)
            self.check_find(table, keys, vals, status, f"λ={lam}")
            lam0 = table.load_factor()
            t_find = self.time_ms(lambda: table.find(keys), sz.timed_runs)
            ins = [self.timed_insert(table) for _ in range(sz.timed_runs)]
            t_ins = statistics.median(ins)
            self.throughput[lam] = (n / t_find / 1e6, n / t_ins / 1e6)
            log(f"phase 3: λ = {lam0:.6f}: find {t_find:.3f} ms ({n / t_find / 1e6:.4f} B-KV/s); "
                f"insert_or_assign of fresh keys from λ {lam0:.6f} to {table.load_factor():.6f}: "
                f"{t_ins:.3f} ms ({n / t_ins / 1e6:.4f} B-KV/s); median of {sz.timed_runs}, batch {n}")
            self.breakdown(table, keys, lam)
        counts = torch.zeros(5, dtype=torch.int64)
        for i in range(3):   # past λ = 1.0, with a burst at one bucket
            keys = self.fresh_keys(n)
            keys[: sz.hot_keys] = self.hot_bucket_keys(table.cfg.num_buckets, sz.hot_keys, 12345 + i)
            vals = self.values(n)
            status = table.insert_or_assign(keys, vals).status
            counts += torch.bincount(status.long().cpu(), minlength=5)
            self.check_find(table, keys, vals, status, f"past λ=1 batch {i}")
        log("phase 3: past λ = 1.0: " + ", ".join(f"{STATUS_NAMES[i]} {int(c)}"
                                                   for i, c in enumerate(counts)))
        require(counts[3] > 0 and counts[4] > 0, "no EVICTED or no REJECTED past λ = 1.0")
        self.sync()
        self.launches = dict(self._build.launch_counts)
        log(f"phase 3: kernel launches on the main path: {json.dumps(self.launches)}")
        if self.dev.type == "cuda":
            missing = [k for k in ("find_scan", "upsert_probe", "claim_scan", "scatter_rows")
                       if self.launches.get(k, 0) == 0]
            require(not missing, f"main path never launched {missing}")
        del table

    def mark(self):
        """A timestamp taken in stream order (a CUDA event on the card)."""
        if self.dev.type == "cuda":
            e = self.torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def elapsed_ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.dev.type == "cuda" else (b - a) * 1e3

    def breakdown(self, table, find_keys, lam):
        """Where one insert_or_assign of fresh keys spends its time: each
        kernel stage between two stream timestamps, the rest (hashing,
        sorts, metadata scatters, host syncs of boolean indexing) as the
        orchestration.  And the share of find's time in key hashing."""
        from repro_torch.core import merge, ops
        from repro_torch.kernels import ops as kops

        spans = []

        def timed(name, fn):
            def run(*args):
                a = self.mark()
                out = fn(*args)
                spans.append((name, a, self.mark()))
                return out
            return run

        base = kops.kernel_stages(table.cfg, table.device)
        stages = merge.UpsertStages(*(timed(f, getattr(base, f)) for f in base._fields))
        n = self.sz.batch
        keys, vals = self.fresh_keys(n), ops._pad_aux(self.values(n), table.state)
        self.sync()
        a = self.mark()
        merge.upsert(table.state, table.cfg, keys, vals, stages=stages)
        b = self.mark()
        self.sync()
        total = self.elapsed_ms(a, b)
        per = {}
        for name, x, y in spans:
            per[name] = per.get(name, 0.0) + self.elapsed_ms(x, y)
        rest = total - sum(per.values())
        log(f"phase 3: λ={lam} insert_or_assign breakdown: total {total:.3f} ms; "
            + "; ".join(f"{k} {v:.3f} ms" for k, v in per.items())
            + f"; orchestration {rest:.3f} ms")
        t_probe = self.time_ms(lambda: self.find_mod.probe_keys(table.cfg, find_keys), 3)
        log(f"phase 3: λ={lam} find: key hashing (probe_keys) {t_probe:.3f} ms of the op")

    def timed_insert(self, table) -> float:
        keys, vals = self.fresh_keys(self.sz.batch), self.values(self.sz.batch)
        return self.time_ms(lambda: table.insert_or_assign(keys, vals), 1, warmup=0)

    def check_find(self, table, keys, vals, status, ctx):
        """The batch just inserted: its admitted keys are found with their
        values; a mix with never-inserted keys finds exactly those."""
        torch = self.torch
        ok = (status >= 1) & (status <= 3)
        require(bool(ok.any()), f"{ctx}: nothing admitted")
        fresh = self.fresh_keys(keys.numel() // 2)
        mix = torch.cat([keys[: keys.numel() // 2], fresh])
        r = table.find(mix)
        half = keys.numel() // 2
        require(r.values.shape == (mix.numel(), DIM) and bool(torch.isfinite(r.values).all()),
                f"{ctx}: find values of the wrong shape or not finite")
        require(torch.equal(r.found[:half], ok[:half]), f"{ctx}: found disagrees with the statuses")
        require(not bool(r.found[half:].any()), f"{ctx}: a never-inserted key was found")
        require(torch.equal(r.values[:half][ok[:half]], vals[:half][ok[:half]]), f"{ctx}: values")
        require(not bool(r.values[half:].any()), f"{ctx}: a miss returned a nonzero row")

    # ----------------------------------------------------------------- report

    def report(self):
        for name, st in sorted(self.stats.items()):
            log(f"parity {name}: bit-identical to the plain version in {len(st['checks'])} "
                f"comparisons ({'; '.join(st['checks'])}), max abs err {st['max_abs_err']}")
        for lam, (f, i) in self.throughput.items():
            log(f"throughput λ={lam}: find {f:.4f} B-KV/s, insert_or_assign {i:.4f} B-KV/s")
        for name, st in sorted(self.stats.items()):
            for lam in (0.5, 1.0):
                bound, by = self.bound(st, lam)
                log(f"kernel {name} λ={lam}: {st[f'ms@{lam}']:.4f} ms, plain "
                    f"{st[f'plain_ms@{lam}']:.4f} ms, bound {bound:.4f} ms by {by} (bytes "
                    f"{self.bytes_ms(st, lam):.4f} ms, operations {self.ops_ms(st, lam):.4f} ms)"
                    + (f", library {st[f'library_ms@{lam}']:.4f} ms" if f"library_ms@{lam}" in st else ""))
        cs = self.stats["claim_scan"]
        for lam in (0.5, 1.0):
            log(f"claim_scan λ={lam}: every query on one cached row {cs[f'ms_one_row@{lam}']:.4f} ms "
                f"against {cs[f'ms@{lam}']:.4f} ms spread over the table; its own s*s compare loop "
                f"at the int32 rate {cs[f'loop_ops@{lam}'] / INT32_OPS_PER_S * 1e3:.4f} ms")
        if self.dev.type == "cuda":
            smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader"], capture_output=True, text=True,
                                 check=True).stdout.strip().splitlines()[0]
            log(smi)

    @staticmethod
    def bytes_ms(st, lam) -> float:
        return st[f"bytes@{lam}"] / HBM_BYTES_PER_S * 1e3

    @staticmethod
    def ops_ms(st, lam) -> float:
        return st[f"ops@{lam}"] / INT32_OPS_PER_S * 1e3

    def bound(self, st, lam) -> tuple[float, str]:
        """The least time for the work: the larger of the bytes' and the
        operations' time, and which of the two it is."""
        b, o = self.bytes_ms(st, lam), self.ops_ms(st, lam)
        return (b, "bytes") if b >= o else (o, "operations")

    def kernel_rows(self) -> list[dict]:
        """One entry per kernel, from this run's λ = 1.0 measurements."""
        meta = {
            "find_scan": ("src/repro_torch/csrc/find_scan.cu", "src/repro/kernels/find_scan.py:350"),
            "upsert_probe": ("src/repro_torch/csrc/upsert_scan.cu", "src/repro/kernels/upsert_scan.py:98"),
            "claim_scan": ("src/repro_torch/csrc/upsert_scan.cu", "src/repro/kernels/upsert_scan.py:189"),
            "scatter_rows": ("src/repro_torch/csrc/scatter.cu", "src/repro/kernels/scatter.py:37"),
        }
        rows = []
        for name, (source, replaces) in meta.items():
            st = self.stats[name]
            bound, by = self.bound(st, 1.0)
            rows.append({
                "name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": self.launches.get(name, 0), "max_abs_err": st["max_abs_err"],
                "ms": st["ms@1.0"], "plain_ms": st["plain_ms@1.0"],
                "bound_ms": bound, "bound_by": by,
                "library_ms": st.get("library_ms@1.0"),
            })
        return rows


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
