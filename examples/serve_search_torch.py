"""End-to-end serving driver on the PyTorch port (the paper's deployment
scenario, §6): the counterpart of ``examples/serve_search.py``, through
``repro_torch`` only (no JAX).

Builds a product-search model at enterprise *geometry* (d = 4M features,
L = 32^4 ≈ 1.05M labels, branching 32; ``--small``: d = 337k, 32k labels)
with ``repro_torch.data.build.build_benchmark_tree``, then drives the serving
stack in the reference's settings:

* **batch**: ``serve_batch``, the Table-4 panel per masked-matmul method;
* **online**: a Poisson request stream through the async
  :class:`~repro_torch.serving.MicroBatcher`, against the blocking
  per-query baseline;
* **partitioned**: ``--partitions P`` splits the label space P ways
  (scatter-gather index) and checks the results against the unpartitioned
  engine;
* **network**: ``--gateway PORT`` serves the model over HTTP
  (:class:`~repro_torch.serving.ServingGateway`); with ``--partitions P``
  against P worker processes exchanging beams over the socket RPC.

``--tier int8`` (or ``int8_pruned`` / ``fp8``) serves a compressed storage
tier (:mod:`repro_torch.quant`), reported as recall against the exact tier.
Everything runs on the card unless ``--device cpu`` is given.

    PYTHONPATH=src python examples/serve_search_torch.py [--queries 256] [--small]
    PYTHONPATH=src python examples/serve_search_torch.py --small --gateway 8080 \\
        [--partitions 2] [--tier int8]
    PYTHONPATH=src python examples/serve_search_torch.py --small --device cpu
"""

import argparse
import json
import time
import urllib.request

import numpy as np
import torch

from repro_torch.data.build import build_benchmark_tree
from repro_torch.data.xmr_data import XMRShape, benchmark_queries
from repro_torch.serving import (
    BatchPolicy,
    MicroBatcher,
    PartitionConfig,
    QuantConfig,
    Query,
    QueryResult,
    ServeConfig,
    ServingGateway,
    XMRServingEngine,
)
from repro_torch.serving.config import QUANT_TIERS


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--beam", type=int, default=10)
    ap.add_argument("--max-batch", type=int, default=16,
                    help="micro-batcher coalescing size")
    ap.add_argument("--max-wait-ms", type=float, default=2.0)
    ap.add_argument("--small", action="store_true",
                    help="32k labels / d=337k (fast demo)")
    ap.add_argument("--partitions", type=int, default=1,
                    help="label-space partitions (scatter-gather index; "
                         "per-device model bytes shrink ~1/P, results stay "
                         "bitwise-identical)")
    ap.add_argument("--gateway", type=int, default=None, metavar="PORT",
                    help="serve over HTTP on this port (0 = ephemeral); "
                         "with --partitions > 1 the engine runs against a "
                         "cross-process worker fleet")
    ap.add_argument("--tier", default="exact", choices=QUANT_TIERS,
                    help="weight storage tier (repro_torch.quant): int8 / "
                         "int8_pruned cut per-partition memory several-"
                         "fold; fp8 is in-process only (no fleet wire)")
    ap.add_argument("--device", default=None,
                    help="torch device to serve on (default: the card; 'cpu' to run without)")
    args = ap.parse_args(argv)
    if args.tier == "fp8" and args.gateway is not None and args.partitions > 1:
        ap.error("--tier fp8 cannot ship over the fleet RPC wire; "
                 "use --tier int8 with --partitions > 1")
    return args


def main(argv=None) -> None:
    args = parse_args(argv)
    if args.small:
        shape = XMRShape("search-32k", 337_067, 32_768, 10_000, 100, 64)
    else:
        shape = XMRShape("search-1m", 4_000_000, 32**4, 10_000, 150, 64)
    rng = np.random.default_rng(0)

    print(f"building model: L={shape.L:,} labels, d={shape.d:,} ...")
    t0 = time.time()
    tree = build_benchmark_tree(shape, 32, rng, device=args.device)
    print(f"  built in {time.time() - t0:.0f}s on {tree.device}, "
          f"{tree.memory_bytes() / 1e9:.2f} GB chunked weights, depth {tree.depth}")

    queries = benchmark_queries(shape, args.queries, rng)

    if args.gateway is not None:
        serve_gateway(tree, queries, args)
        return
    if args.partitions > 1:
        serve_partitioned(tree, queries, shape, args)
        return
    batch_panel(tree, queries, shape, args)
    online(tree, queries, shape, args, rng)
    print("\n(paper Table 4 at 100M labels on a single x86 thread: "
          "0.88 ms MSCM vs 7.28 ms vanilla — an 8x ratio; compare the ratios.)")


def batch_panel(tree, queries, shape, args) -> dict:
    """The batch setting, one engine a method; returns ``{method: (scores,
    labels)}``. A non-exact tier forces the quantized kernel, so the panel
    collapses to the tier's method."""
    print("\n== batch setting (Table 4 panel) ==")
    methods = (("mscm_dense", "mscm_searchsorted", "vanilla")
               if args.tier == "exact" else ("auto",))
    out = {}
    for method in methods:
        eng = XMRServingEngine(
            tree,
            ServeConfig(beam=args.beam, topk=10, method=method, ell_width=256, max_batch=64,
                        quant=QuantConfig(tier=args.tier)),
            device=args.device,
        )
        eng.warmup(shape.d, batch_sizes=(64,))
        t0 = time.time()
        out[method] = eng.serve_batch(queries)
        wall = time.time() - t0
        s = eng.latency_summary()["amortized"]
        print(f"{method:20s} amortized {s['avg_ms_per_query']:7.3f} ms/q "
              f"over {s['queries']} queries "
              f"({wall:.1f}s wall; per-query percentiles are an online-"
              f"setting metric)")
    return out


def online(tree, queries, shape, args, rng) -> list:
    """The online setting: the blocking per-query loop, then Poisson
    arrivals at twice its rate through the micro-batcher. Returns the
    batcher's ``(scores, labels)`` a query."""
    print("\n== online setting (async micro-batching) ==")
    eng = XMRServingEngine(
        tree, ServeConfig(
            beam=args.beam, topk=10,
            method="mscm_dense" if args.tier == "exact" else "auto",
            ell_width=256, max_batch=64, quant=QuantConfig(tier=args.tier)),
        device=args.device)
    eng.warmup_buckets(shape.d, args.max_batch)

    n = min(args.queries, 128)
    t0 = time.perf_counter()
    eng.serve_online(queries, limit=n)
    base_qps = n / (time.perf_counter() - t0)
    print(f"{'per-query baseline':24s} {base_qps:8.1f} QPS (blocking loop)")

    mb = MicroBatcher(eng, BatchPolicy(args.max_batch, args.max_wait_ms))
    mb.start()
    try:
        futs = []
        for i in range(n):  # Poisson arrivals at 2x the baseline's capacity
            time.sleep(rng.exponential(1.0 / (2.0 * base_qps)))
            futs.append(mb.submit(*queries.row(i)))
        res = [f.result(timeout=300) for f in futs]
    finally:
        mb.stop()
    print(mb.metrics.table4_row(f"microbatch-{args.max_batch}"))
    return res


def serve_partitioned(tree, queries, shape, args):
    """Scatter-gather: the label space split P ways, end to end. Shows the
    manifest, serves the stream through the unpartitioned engine and the
    partitioned one behind a micro-batcher, and compares them: bitwise on
    the exact tier (the paper's enterprise scenario, a tree bigger than one
    device, without a changed bit), recall on a compressed one. Returns
    ``(scores, labels, ref_scores, ref_labels)``."""
    p = args.partitions
    print(f"\n== partitioned serving (scatter-gather, P={p}) ==")
    ref = XMRServingEngine(tree, ServeConfig(beam=args.beam, topk=10, max_batch=64),
                           device=args.device)
    ref_s, ref_l = ref.serve_batch(queries)

    engine = XMRServingEngine(
        tree, ServeConfig(beam=args.beam, topk=10, max_batch=64,
                          partition=PartitionConfig(partitions=p),
                          quant=QuantConfig(tier=args.tier)),
        device=args.device)
    m = engine.index.manifest
    print(f"split level {m.level}; router {m.router_memory_bytes / 1e6:.1f} MB"
          f" (replicated); per-device max "
          f"{m.max_partition_bytes() / 1e6:.1f} MB of "
          f"{m.total_memory_bytes / 1e6:.1f} MB total "
          f"({m.shrink_ratio():.2f}x shrink)")
    for info in m.partitions:
        print(f"  partition {info.pid}: labels [{info.label_start:>9,}, "
              f"{info.label_end:>9,})  {info.memory_bytes / 1e6:7.1f} MB  "
              f"tier {info.tier}/{info.dtype}  hash {info.content_hash}")

    mb = MicroBatcher(engine, BatchPolicy(args.max_batch, args.max_wait_ms))
    with mb:
        res = [f.result(timeout=600) for f in mb.submit_csr(queries)]
    s = np.stack([r[0] for r in res])
    l = np.stack([r[1] for r in res])
    if args.tier == "exact":
        identical = np.array_equal(s, ref_s) and np.array_equal(l, ref_l)
        print(f"\nbitwise-identical to unpartitioned: {identical}")
    else:
        from repro_torch.quant import recall_at_k, score_mae

        print(f"\nquantized tier '{args.tier}' vs exact: "
              f"recall@10 {recall_at_k(ref_l, l):.4f}, "
              f"score MAE {score_mae(ref_s, s, 10):.5f}")
    summ = mb.metrics.summary()
    print(f"partition occupancy (share of top-k per partition): "
          f"{summ.get('partition_occupancy')}")
    print(mb.metrics.table4_row(f"partitioned-P{p}"))
    return s, l, ref_s, ref_l


def serve_gateway(tree, queries, args):
    """Serve the model over HTTP, in process or against a worker fleet.

    With ``--partitions P`` the engine's per-level merge runs against P
    worker processes (``repro_torch.serving.fleet``) exchanging beams over
    a socket RPC; the answers are the in-process engine's either way. Demo
    traffic goes through real HTTP requests, so the printed numbers include
    the network edge. Returns the answers' ``(scores, labels)``."""
    p = args.partitions
    quant = QuantConfig(tier=args.tier)
    cfg = ServeConfig(beam=args.beam, topk=10, max_batch=64, quant=quant)
    if p > 1:
        cfg = ServeConfig(
            beam=args.beam, topk=10, max_batch=64, quant=quant,
            partition=PartitionConfig(partitions=p, partition_sync="pipelined"),
        )
    engine = XMRServingEngine(tree, cfg, device=args.device)

    fleet = None
    if p > 1:
        from repro_torch.serving.fleet import PartitionFleet

        print(f"\nlaunching {p} partition workers ...")
        fleet = PartitionFleet.launch(p, device=args.device).attach(engine)
        print(f"  workers up: {fleet.ping()}")

    scores, labels = [], []
    try:
        mb = MicroBatcher(engine, BatchPolicy(args.max_batch, args.max_wait_ms))
        with mb, ServingGateway(mb, port=args.gateway, fleet=fleet) as gw:
            print(f"\n== HTTP gateway on {gw.url} ==")
            print(f"  POST {gw.url}/v1/query   "
                  '{"v": 1, "idx": [...], "val": [...]}')
            print(f"  GET  {gw.url}/healthz    GET  {gw.url}/metrics")
            print("  curl example:")
            idx, val = queries.row(0)
            wire = Query(idx=idx[:3], val=val[:3]).to_wire()
            print(f"    curl -s {gw.url}/v1/query -d '{json.dumps(wire)}'")

            n = min(args.queries, 64)
            t0 = time.perf_counter()
            for i in range(n):
                idx, val = queries.row(i)
                req = urllib.request.Request(
                    gw.url + "/v1/query",
                    data=json.dumps(Query(idx=idx, val=val, qid=i).to_wire()).encode(),
                    headers={"Content-Type": "application/json"},
                )
                with urllib.request.urlopen(req, timeout=300) as resp:
                    res = QueryResult.from_wire(json.load(resp))
                if not (res.ok and res.qid == i):
                    raise RuntimeError(f"query {i}: {res}")
                scores.append(np.asarray(res.scores, np.float32))
                labels.append(np.asarray(res.ids))
            wall = time.perf_counter() - t0
            print(f"\nserved {n} queries over HTTP in {wall:.1f}s "
                  f"({n / wall:.1f} QPS incl. network edge)")
            with urllib.request.urlopen(gw.url + "/metrics", timeout=30) as resp:
                summ = json.load(resp)
            print(f"avg_batch={summ.get('avg_batch', 0):.1f} "
                  f"p50={summ.get('p50_ms', 0):.2f}ms "
                  f"p99={summ.get('p99_ms', 0):.2f}ms")
            if fleet is not None:
                print(f"partition occupancy: {summ.get('partition_occupancy')}")
    finally:
        if fleet is not None:
            fleet.close()
    if engine.device.type == "cuda":
        print(f"on {torch.cuda.get_device_name(engine.device)}")
    return np.stack(scores), np.stack(labels)


if __name__ == "__main__":
    main()
