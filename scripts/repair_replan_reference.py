#!/usr/bin/env python3
"""The reference (``src/repro``, JAX, on the CPU) on ``chip_smoke.py``
phase 9c's schedule: a static repair-oblivious plan against the
repair-aware ``AdaptiveReplanner`` on the same draws.

The §V.B catalog (r = 1000, 12 nodes, theta = 2) with a tenth of its bytes
in a hot tier; its cache-aware plan (eps 3e-4) is the static plan. Eight
segments; node 0 down in segments 2-4 with repair rows paced at the
node-failure-repair scenario's share of the client rate
(``src/repro/scenarios/library.py:86``, 0.05 against 0.115 reads/s); the
hot tier out in segment 6. The adaptive policy re-plans where availability
changes (segments 2 and 5) from EWMA estimates, with rollouts from the live
queue state. Prints, per segment, each policy's clients' mean and p99 and
the busiest node's utilisation, and the repair share of the reads.

    PYTHONPATH=src python scripts/repair_replan_reference.py --requests 20000
"""
from __future__ import annotations

import argparse
import time

import jax
import jax.numpy as jnp
import numpy as np

import repro.core as R
import repro.serving as RSV
import repro.storage as RS

MB = float(2**20)
SEGMENTS, SEG_DOWN, SEG_OUTAGE = 8, (2, 5), 6
REPAIR_SHARE_OF_CLIENT = 0.05 / sum((0.045, 0.035, 0.02, 0.015))


def catalog(r: int = 1000, file_mb: float = 150.0):
    """chip_smoke.py's paper_catalog: k = 6, 7, 6, 4 by quarter."""
    ks = np.zeros(r, np.float32)
    ks[0::4], ks[1::4], ks[2::4], ks[3::4] = 6, 7, 6, 4
    lam = np.zeros(r, np.float32)
    lam[0::3] = 1.25 / 10000
    lam[1::3] = 1.25 / 10000
    lam[2::3] = 1.25 / 12000
    return lam, ks, file_mb / ks


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--requests", type=int, default=100_000)
    ap.add_argument("--max-iters", type=int, default=150)
    ap.add_argument("--rollout-requests", type=int, default=20_000)
    ap.add_argument("--seed", type=int, default=9)
    args = ap.parse_args()
    n, r = args.requests, 1000
    cl = RS.tahoe_testbed()
    lam, ks, chunk = catalog(r)
    lam64 = lam.astype(np.float64)
    eff = float(np.average(chunk, weights=lam))
    fbytes = ks.astype(np.float64) * chunk * MB
    model = RS.CacheModel(file_bytes=fbytes, capacity_bytes=0.1 * fbytes.sum(),
                          hit_latency=0.5, hot_price_per_mb=0.02)
    ttl = model.ttl(lam64)
    prob = R.JLCMProblem(lam=jnp.asarray(lam), k=jnp.asarray(ks), moments=cl.moments(eff),
                         cost=cl.cost, theta=2.0, cache=model.spec(lam64))
    aware = R.solve(prob, eps=3e-4, max_iters=300)
    placement = np.asarray(aware.placement)
    avail_seq = np.ones((SEGMENTS, 12), bool)
    avail_seq[slice(*SEG_DOWN), 0] = False
    repair_rate = REPAIR_SHARE_OF_CLIENT * float(lam64.sum())
    flow = RS.build_repair_flow(placement, ks, avail_seq[SEG_DOWN[0]], repair_rate)
    pi_aug, lam_aug = RS.augment_plan(np.asarray(aware.pi), lam, flow)
    scale = np.ones((SEGMENTS, 2 * r), np.float32)
    scale[:, r:] = 0.0
    scale[slice(*SEG_DOWN), r:] = 1.0
    print(f"static plan: {int(aware.iterations)} iterations, bound "
          f"{float(aware.latency_tight):.4f} s; repair {repair_rate:.6g} reads/s against "
          f"{float(lam64.sum()):.6g}; {n} requests a segment")

    est = RSV.EwmaMomentEstimator(prior=cl.moments(eff))
    rates = RSV.EwmaRateEstimator(prior=model.thin(lam64))
    rp = RSV.AdaptiveReplanner(k=ks.copy(), cost=np.asarray(cl.cost), theta=2.0,
                               estimator=est, cache=model, max_iters=args.max_iters,
                               rollout_requests=args.rollout_requests)
    rp.last_ttl, rp.last_raw = ttl, lam64.copy()
    keys = jax.random.split(jax.random.key(args.seed), SEGMENTS)
    carries = {"static": None, "adaptive": None}
    pi_client, repair_pi, ttl_cur = np.asarray(aware.pi), flow.pi, ttl
    for s in range(SEGMENTS):
        avail = avail_seq[s]
        if s in (SEG_DOWN[0], SEG_DOWN[1]):  # availability changes: re-plan
            t0 = time.perf_counter()
            active = s < SEG_DOWN[1]
            pi_client = rp.replan(rates.rates, avail, pi0=pi_client, carry=carries["adaptive"],
                                  key=jax.random.fold_in(keys[s], 1),
                                  repair=flow if active else None)
            repair_pi = rp.repair_pi if active else flow.pi
            ttl_cur = rp.last_ttl
            print(f"  replan before segment {s}: {time.perf_counter() - t0:.2f} s, iterations "
                  f"{rp.solve_iters[-1]}, solve {rp.solve_walls[-1]:.2f} s, rollouts "
                  f"{rp.rollout_walls[-1]:.2f} s")
        row = []
        for policy in ("static", "adaptive"):
            if policy == "static":
                pi, t = pi_aug, ttl
            else:
                pi, t = np.concatenate([pi_client, repair_pi]), ttl_cur
            t = np.zeros(2 * r) if s == SEG_OUTAGE else np.concatenate([t, np.zeros(r)])
            res, carries[policy] = RS.simulate_segment(
                keys[s], jnp.asarray(pi, jnp.float32), jnp.asarray(lam_aug, jnp.float32), cl,
                eff, n, avail=avail, rate_scale=scale[s], carry=carries[policy],
                cache_ttl=jnp.asarray(t, jnp.float32), cache_hit_latency=0.5)
            fid, lat = np.asarray(res.file_id), np.asarray(res.latency)
            client = fid < r
            arr = np.asarray(res.arrival)
            if policy == "adaptive":
                est.update(res.obs)
                rates.update_misses(fid[client], np.asarray(res.hit)[client], arr[-1] - arr[0])
            util = float((np.asarray(res.node_busy) / (arr[-1] - arr[0])).max())
            row.append(f"{policy} mean {lat[client].mean():.4g} p99 "
                       f"{np.quantile(lat[client], 0.99):.4g} util {util:.4f}")
        print(f"segment {s}: repair share {float((~client).mean()):.4f}; " + "; ".join(row))


if __name__ == "__main__":
    main()
