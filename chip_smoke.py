#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

Run from the root of a checkout on a machine with an NVIDIA H100:
``python3 chip_smoke.py``. It builds the CUDA kernels from the checkout's
sources (nvcc, one process per source, all started together, into
build/kernels/) and, beside them, the host library
(ops/csrc/pio_scan.cpp: JSONL scan, COO group-by, cooccurrence top-N;
g++ into build/native/), then drives the main path of every template.
Each phase that returns prints its thread, start and seconds.

The recommendation template (ALS, kernel B1):

1. kernel phase: kernel B1 (csrc/spd_cg.cu) against its plain PyTorch
   version on the card, on well-conditioned systems at ranks
   10/16/32/64/100 and, one block per system, 160 and 256; then one
   system at f = 11,700, past a block's shared memory (the grid plan);
2. train phase: the recommendation template's ALSAlgorithm.train at the
   ML-20M shape (138,000 users x 27,000 items x 20 M synthetic ratings,
   rank 32, 10 iterations), held-out RMSE gated at 0.45, with B1's launch
   count read around the run and its ratings grouped by the host library
   (the user side's group-by held bit for bit to numpy's stable argsort,
   both timed); then B1 against the plain version on the
   real user-side and item-side systems of that model and on 138,001
   rank-10 systems, each timed beside the plain version and a library
   Cholesky solve, eager (``ms``) and as a replayed CUDA graph
   (``graph_ms``); then pio doctor in four processes (beside the serve
   phase): the inventory names
   the card, --capacity 138000 27000 32 --ann 2048,16 beside that train's
   measured torch.cuda.max_memory_allocated, --mesh data=2 --gather-dtype
   bf16 beside each rank's of the 2-rank sharded train (3m), and
   --roofline's B1/B2/B3 bounds equal to PERF.md's kernel table;
3. serve phase: the port's CLI in subprocesses (app new, import of an
   ML-100K-shape event file, train, deploy) answering POST /queries.json;
   then the ingest path: app new, accesskey new and eventserver on one
   sqlite store, 100,000 ML-100K-shape rate events posted in POST
   /batch/events.json requests of 50 and 1,000 single POST /events.json
   (every status 201, the counts read back, an event at +08:00 read back
   at +08:00), train (B1, rank 10) and deploy from that store, 200 queries;
   B1 held to its plain version on that train's systems at row-relative
   1e-4, and no process of the path importing JAX, the JAX package or
   aiohttp; with that event server still up, the serving contract through
   the CLI: pio deploy with TLS (an openssl certificate), an access key,
   feedback into the event server, a remote log, request timeout 2 s,
   queue high water 32 and drain grace 5 s; 100 HTTPS queries answer 200,
   401 without the key, 400 plus one remote-log body for a failing query,
   one predict event per answered query in the store, a silent TCP client
   delaying nobody, SIGTERM amid a burst of 32 (/healthz 503 while
   draining, every accepted query 200, exit 0 within the grace), a retrain
   through B1 and pio undeploy --ssl of its deploy; pio profile train of the
   same retrain (its torch.profiler trace holds spd_cg_registers exactly as
   often as B1's wrapper counted); then the ML-20M model
   served in-process through
   ServingIndex.serve_batch and checked against a plain torch.topk;
3a. batchpredict: that model through the offline pipeline (run_pipeline), a
   69,000-line query file (every other user) in mega-batches of 512 into a FileSink and a
   MemorySink, every row line-aligned and equal to serve_batch for its
   user, users/s and the five phases' p50;
3b. the offline CLI on the event server's store (it and 3e run on one of
   three threads, after 3j, beside 8, 12, 17 and 3n, while this thread runs
   the recommendation variants, 11 and 15; none of them times a kernel or
   reads a latency against a limit): batchpredict
   --from-events --to-events (a line and a write-back event per user),
   undeploy of a deployed server (it exits 0 within 10 s), status, version,
   template list; eval of the recommendation template, rank {10, 20} x
   lambda {0.01, 0.1} x 2 folds = 8 cells by precision@10, in-process
   (B1's launches: 8 x 2 x 10), with 2 workers (the same cells, scores
   within 0.02) and resumed (0 cells retrained); B1 held and timed on an
   eval cell's rank-20 systems;
3c. stream fold-in: the ML-20M model published as stable into a model
   registry, 100,000 rate events (75,000 by 3,750 active users, 25,000 by
   2,500 new users) in a sqlite event store, drained 500 at a time through
   FoldInALSTrainer on the card (two B1 launches an absorb, each held to the
   plain version at row-relative 1e-4; 1,000 folded users held to a float64
   solve) into StreamPipeline, which publishes and stages 4 canary
   candidates; the stable pins an ANN index, and each candidate publish
   refreshes it (each refresh's path, drift and seconds; no ann error);
   events/s, the p50 of an absorb's build, upload, B1 and fetch, each
   publish's seconds;
3d. rollout lanes: a QueryServer on the card deployed from that registry
   with registry sync every 0.5 s adopts the canary candidate, both lanes
   with their ANN indexes attached; 1,000
   queries route by sticky bucket (share 0.1 +- 0.03), each answer equal to
   its lane's serve_batch; promote, stage then rollback, a shadow candidate
   (answers from stable, divergence recorded), five stage/promote cycles
   (card memory within 10 %), POST /reload;
3f. the serving contract in-process at full width: that model in a
   QueryServer on the card with TLS, an access key, feedback into an
   event server on the fold-in's store, a remote log, an output blocker
   and a sniffer, request timeout 1 s, queue high water 64, breaker
   threshold 2 and recovery 1 s: 1,000 queries from 16 clients, each the
   blocker's rewrite of serve_batch and each seen by the sniffer, p50 and
   qps beside a server with none of it; predict_batch_dispatch hung
   through FaultInjector (503 + Retry-After within 1.5 s, two watchdog
   trips, the breaker open and /healthz 503, then half-open and closed,
   answers equal again); a burst of 512 concurrent queries (each shed one
   503 + Retry-After, the rest 200 and equal, no 500 and no reset); card
   memory within 10 % across the chaos (the result cache off: the phase
   counts dispatched work);
3g. observability in-process at full width: that model in a QueryServer on
   the card with the result cache (1,024 entries, 10 s TTL): 1,000 users
   from 16 clients, then the same 1,000 again, each query with its own
   X-Pio-Trace-Id; every answer serve_batch's, cache hits and misses 1,000
   each, every id echoed and in /traces/recent, the misses' phase means
   within 10 % of their mean pio_request_seconds, every contract family on
   /metrics, OpenMetrics exemplars resolving in /traces/recent, /slo's
   three objectives; two 500 ms torch.profiler captures amid traffic (a
   third during the first answers 409); card memory flat; p50 and qps of
   misses and hits beside 3f's contract-off server, the sampler's own
   overhead share;
3e. the registry CLI on the event server's store, every process with
   PIO_ANN_MIN_ITEMS=0: train --registry-dir (its version pins an index),
   models list, deploy --registry-dir --registry-sync-interval 0.5, 5,000
   more events through POST /batch/events.json, stream --cycles 3
   --notify-url (its own process, B1 twice an absorb; its candidate pins a
   refreshed index), 200 queries, models
   promote and rollback (the server adopts both), eval --publish (the
   winner lands as the candidate); stream --obs-dir over 900 ratings by
   existing users drawn with replacement (the drift guard suppresses the
   publish: one drift line on the telemetry ring, one stream-drift bundle
   pio incidents list reads); B1 held and timed on a rank-10 fold-in's
   systems;
3h. the bandit lanes in-process at full width: a QueryServer on the card
   from a registry holding the ML-20M stable and the fold-in's candidate,
   bandit_policy thompson and the gate's default latency veto (1.5x at
   equal batch sizes, and more slow candidate batches than an equal lane's
   tail gives; the ratios and slow-batch counts it read are kept), rewards
   in the fold-in's store: waves of 128
   queries from 16 clients, each answered user converting with its arm's
   probability (a reward event carrying the answer's trace id), a bake tick
   between waves; round one (candidate 0.30, stable 0.15) promotes, round
   two (the old stable re-staged, 0.05 against 0.30) retires; every answer
   its lane's serve_batch, pulls, rewards and matched rewards exact,
   pio_bandit_active 1 then 0, no 5xx, card memory flat; p50 and qps beside
   the plain bake gate's;
3n. the recommendation template on a jsonl event store through the CLI:
   app new, import of 100,000 ML-100K-shape rate events, one more line
   appended without its newline, train (20 B1 launches; its columnar read
   through the host library's scan and its group-by through the host
   library), deploy, 200 queries equal to serve_batch of the model read
   back; the train's read through the host library equal to the python
   encoder's, and neither nor the model holding the partial line;
3o. the recommendation template's five variants in-process on the card
   (ML-100K shape, rank 10, one jsonl store): each trains with 20 B1
   launches and answers 64 queries, each the top of its user's float64
   scores over what the variant may serve (blacklist-items,
   customize-data-prep, customize-serving with its file edited live,
   reading-custom-events at ratings 4 and 1, train-with-view-event
   implicit);
3i. the lifecycle loop through the CLI, after 3e in its directory: deploy
   --bandit thompson, eventserver, lifecycle run started by 3e's drift
   line, SIGKILLed after the grid's first ledger line and restarted (the
   restarted grid trains only the cells its ledger lacks, on the CPU), the
   winner staged, reward events through POST /batch/events.json until the
   bandit promotes, at most 8 warm queries that are cache hits afterwards;
   lifecycle status/trigger/pause/resume, top --once --json, top
   --lifecycle, the admin server and the dashboard;
3j. the serving fleet through the CLI at full width (after 3h, from a
   registry of the ML-20M stable and the fold-in's candidate): deploy
   --fleet 2 --fleet-max 2 --autoscale --cpu-fallback-max 1, the kernels
   built before it starts; 2,000 queries from 16 clients through the
   gateway and straight to w0 (the gateway's hop), every answer
   serve_batch's; one card context per device worker; w0 SIGKILLed amid
   traffic with no answer but 200, restarted and readmitted, a
   worker-crash bundle; a flood from 48 clients until a cpu-fallback
   replica serves (no card context, answers serve_batch's); a stage and a
   promote through the gateway on every worker; pio top --fleet; SIGTERM,
   exit 0 and no worker left;
3k. the lifecycle controller in the fleet parent, after 3i in its
   directory: deploy --fleet 2 --lifecycle; one drift line, the retune on
   the CPU, the canary on both workers, a promote through the gateway, at
   most 8 warm queries through it, cache hits when sent again;
3l. a SQL event store with Elasticsearch metadata through the CLI, right
   after the ingest path: EVENTDATA the generic sql type over sqlite3
   (four scan partitions), METADATA tests/es_mock.py as a process of its
   own, MODELDATA localfs; app new, import of 100,000 ML-100K-shape rate
   events, train (20 B1 launches, held to the plain version), deploy, 200
   queries equal to serve_batch of the model read back from MODELDATA, and
   a chunked POST /queries.json then GET / on one keep-alive connection;
   the train's columnar read and the partitioned scan equal the imported
   arrays in canonical order;
3m. more than one rank, beside the phases from 3 to 3g (each rank this
   script as ``--rank-phase NAME WORK`` through the port's launcher):
   sharded_cli, pio train --num-hosts 2 with distributed: true on an
   ML-100K-shape sqlite store (two gloo ranks sharing the card, B1 twice
   an iteration on each, the coordinator alone recording the instance and
   the model), pio deploy, 200 queries equal to serve_batch of the
   persisted model; sharded_als, ALS at the ML-20M shape on 2 gloo ranks,
   then on 1 NCCL rank (B1's first launches on each rank held to the plain
   version, held-out RMSE <= 0.45, the factors against the one-rank train
   of phase 2, each iteration's all-gather seconds); twotower_parallel, a
   few full-width two-tower steps on 2 ranks at data=2 and at model=2
   under ring and ulysses (B2 on each rank under ulysses, held; step 1's
   loss and parameters against one rank's step on the same batch; at
   model=2 the id tables sharded, a shard held to its rows, each rank's
   parameter, gradient and Adam bytes half the tables' fewer, one ulysses
   step through the sharding inspector); twotower_sharded_cli, pio train
   --num-hosts 2 of the two-tower template with mesh data=1,model=2 on an
   ML-100K-shape view file (944 users), pio deploy, 200 queries held to
   the persisted model (B2 on both ranks and the server); tools_cli,
   build, unregister, start-all / stop-all and pio shell (on the card and
   with --device cpu); lint_cli, pio lint of the port from the checkout
   (no git): 0 findings over every .py file of the package and examples/,
   the same report from python -m predictionio_tpu_torch.analysis.cli with
   no torch, numpy, jax or JAX package module imported, SARIF 2.1.0, no
   stale suppression, and a .cpu() appended to a copy of a serving module
   found at its line;
4. rank 160: ALSAlgorithm.train at the ML-1M shape through B1's
   block-per-system plan, B1 against the plain version on its user-side
   systems and on 2,048 rank-256 systems, each timed.

The sequential template (attention scorer, kernels B1, B2 and B3):

5. kernel phase: B2 (csrc/attention_block.cu) and B3
   (csrc/flash_attention.cu) against their plain versions and the f32
   reference, causal and not, at the scorer's widths, at ragged lengths,
   with Lq != Lk, at head widths 160 and 256 and, for B2, with a
   10,000-key axis and at 70,000 batch·heads;
6. train phase: AttentionAlgorithm.train at the ML-1M shape (6,040 users x
   3,706 items x 1,000,209 synthetic view events from the bench's hop
   generator, rank 32, 10 iterations), B1's launches read around it, and
   held-out hit-rate@10 of the attention and Markov scorers;
7. serve phase: that model through AttentionAlgorithm.predict_batch_dispatch
   in batches of 64 at context 8, 200 and 1024, with B2's (or B3's)
   launches read around each context, served scores held against a
   torch.topk over the plain-version session vectors, and each kernel
   timed at its serving shape beside its bound, its plain version and
   torch's scaled_dot_product_attention as a yardstick: eager calls by CUDA
   events (``ms``, host cost included) and a replayed CUDA graph
   (``graph_ms``, device time per launch);
7a. batchpredict: all 6,040 users through the offline pipeline at context
   200 (B2) and 1024 (B3) in mega-batches of 512, one launch per
   mega-batch, every answer equal to predict_batch_dispatch's in batches
   of 64, each kernel timed at the mega-batch shape;
8. CLI phase: app new, import of an ML-100K-shape view file, train and
   deploy of the attention algorithm, then POST /queries.json; then the
   same model deployed at context 200 and 1024, each captured by pio
   profile serve --ms 500 while it answers: pio profile show lists
   attention_block_kernel / flash_attention_kernel within 1 of the
   launches B2's / B3's wrapper counted over the capture (a second capture
   during the first answers 409).

The two-tower template (its history encoder through B2, forward in
training and serving):

9. train phase: TwoTowerAlgorithm.train at full width (138,000 users x
   27,000 items, embed 64, hidden [128], out 32, 2 heads, historyLen 256,
   batch 4096) for one epoch of 244 steps over 1,000,000 ML-20M-shape
   ratings, one B2 launch per step, a finite falling loss; the step split
   into B2's forward, the attention backward, Adam and the rest;
10. serve phase: predict_batch_dispatch in batches of 64 with histories,
   one B2 launch per dispatch, held against the plain version; B2 timed
   at the training and serving shapes beside its bound and SDPA;
11. quality phase: recall@10 on the bench's clustered data with and
   without a 32-item encoder;
12. CLI phase: app new, import, train with historyLen 50 from an
   engine.json naming the JAX package's factory string, deploy, POST
   /queries.json.

The rest of the template gallery (similar-product, e-commerce and
recommended-user train implicit ALS through kernel B1 at rank 10):

13. similar-product: the multi-events-multi-algos variant at the ML-1M
   shape (views-ALS, like-ALS, cooccurrence n = 20 through the host
   library, its map equal to the scipy formulation's), B1 on the views
   train's own systems, batches of 64 filtered queries checked against
   their filters and the plain product; the same-cluster share of the
   top-10 on the bench's clustered data;
14. e-commerce: 20,000 users x 10,000 items, 0.235 M events imported with
   import_events into a sqlite store, trains at 10 and (adjust-score) 20
   iterations, batches of 64 known and cold users with live reads through
   LEventStore at cacheTtlS 0 and 60;
15. recommended-user: 50,000 users in 50 communities, 1,000,000 follows,
   the same-community share of the top-10;
16. classification: naive Bayes scores of 200,000 points on the card
   against the float64 host labels; the add-algorithm variant from the
   store;
17. CLI: each of the four from the JAX package's engine.json, app new ->
   import -> train -> deploy (the four side by side) -> 200 queries (one
   server at a time).

ANN retrieval (predictionio_tpu_torch/ann), every answer held to the exact
top-k over its probed candidates in float64:

18. searcher: bench.py's ANN corpus (100,000 clustered unit vectors at
   f = 32), f32 and int8 indexes built on the card at default sizing, the
   four searches over 40 batches of 64, recall@10 against the exact top-k,
   the candidates scored, the search p50 beside the exact dot_top_k's;
19. similar-product at a 100,000-item catalog (ML-20M's users and 10 M
   events as views): the train (20 B1 launches, held at 1e-4) publishes
   into a registry with an index at the default AnnConfig, a QueryServer
   deployed from it answers 1,000 queries (half filtered) through it, 0
   fallbacks; then an int8 index: filter-less batches through search_q8,
   filtered ones exact and counted;
20. two-tower (after its serve phase) and sequential (after its
   batchpredict phase, at context 200 and 1024) through indexes at
   AnnConfig(min_items=0), B2/B3 launches counted per dispatch, recall@10
   against the exact path.

Every phase that fails raises, so the script exits non-zero and prints no
result. Before the temp home goes, stderr gets the failing phase's name and
exception and the last lines of each .err file written since that phase
began (kept also from work directories a phase removed on its way out).
The last line is ``{"ok": true, "device": {...}}``; the line before
it is nvidia-smi's name and power limit; before that one JSON line lists
every kernel with its launches on the main paths, errors and times.
"""

from __future__ import annotations

import concurrent.futures
import datetime
import faulthandler
import http.client
import itertools
import json
import os
import queue
import re
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np

SOURCE = "predictionio_tpu_torch/ops/csrc/spd_cg.cu"
REPLACES = "predictionio_tpu/ops/spd_solve.py:76"
KERNELS = ["spd_cg", "attention_block", "flash_attention"]


_T0 = time.perf_counter()
_T0_WALL = time.time()
# nvidia-smi's name and power limit of the card, beside every number printed
GPU = ""
# card-memory peaks of the main path, read by pio doctor's check
PEAKS: dict[str, int] = {}
# train_phase's one-rank ML-20M factors and held-out RMSE, which the
# sharded train is held to
ONE_RANK_ALS: dict = {}
# PERF.md's kernel table: (kernel, shape) -> (bound ms as printed, decimals)
TABLE_BOUNDS = {
    ("spd_cg", (("f", 32), ("n", 138001))): (0.183, 3),
    ("spd_cg", (("f", 32), ("n", 27001))): (0.036, 3),
    ("spd_cg", (("f", 10), ("n", 138001))): (0.0198, 4),
    ("spd_cg", (("f", 160), ("n", 6041))): (0.788, 3),
    ("attention_block", (("batch", 4096), ("causal", False), ("d", 32), ("heads", 2), ("lk", 256),
                         ("lq", 256), ("shared_qkv", False))): (0.321, 3),
    ("attention_block", (("batch", 64), ("causal", False), ("d", 32), ("heads", 2), ("lk", 256),
                         ("lq", 256), ("shared_qkv", False))): (0.0050, 4),
    ("attention_block", (("batch", 64), ("causal", True), ("d", 32), ("heads", 1), ("lk", 200),
                         ("lq", 200), ("shared_qkv", True))): (0.00098, 5),
    ("flash_attention", (("batch", 64), ("causal", True), ("d", 32), ("heads", 1), ("lk", 1024),
                         ("lq", 1024), ("shared_qkv", True))): (0.0086, 4),
}


def emit(**fields) -> None:
    """One JSON line of a phase's results, with the script's elapsed seconds
    (one write, so that lines of phases on other threads never interleave)."""
    sys.stdout.write(json.dumps({**fields, "elapsed_s": time.perf_counter() - _T0}) + "\n")
    sys.stdout.flush()


# the .err files phases' processes wrote: path -> (mtime, last lines), kept
# when a work directory is removed, so a failure can still show them
ERR_TAILS: dict[str, tuple[float, str]] = {}
# every work directory a phase made, so a failure can read what is left
WORK_DIRS: list[str] = []
ERR_TAIL_LINES = 30


def work_dir(prefix: str, dir: str | None = None) -> str:
    """A phase's work directory (``tempfile.mkdtemp``), registered so a
    failing run reads the .err files left in it."""
    path = tempfile.mkdtemp(prefix=prefix, dir=dir)
    WORK_DIRS.append(path)
    return path


def harvest_err_files(top: str) -> None:
    """Keep the last lines of every .err file under ``top``."""
    for dirpath, _, names in os.walk(top):
        for name in names:
            if name.endswith(".err"):
                path = os.path.join(dirpath, name)
                try:
                    with open(path, errors="replace") as fh:
                        tail = "".join(fh.readlines()[-ERR_TAIL_LINES:])
                    ERR_TAILS[path] = (os.path.getmtime(path), tail)
                except OSError:
                    pass


def remove_work(path: str) -> None:
    """Remove a work directory, keeping its .err files' last lines."""
    harvest_err_files(path)
    shutil.rmtree(path, ignore_errors=True)


def phase(fn):
    """Mark an exception leaving a phase with the phase's name and start
    time (the innermost phase's mark stands), for :func:`report_failure`;
    a phase that returns emits its thread, start and seconds."""
    name = fn.__name__.removesuffix("_phase")

    def wrapper(*args, **kwargs):
        t0 = time.time()
        start_s = time.perf_counter() - _T0
        try:
            result = fn(*args, **kwargs)
        except BaseException as exc:
            if not hasattr(exc, "smoke_phase"):
                exc.smoke_phase = (name, t0)
            raise
        emit(phase="phase_s", name=name, thread=threading.current_thread().name, start_s=start_s,
             seconds=time.perf_counter() - _T0 - start_s)
        return result

    wrapper.__name__, wrapper.__doc__ = fn.__name__, fn.__doc__
    return wrapper


def report_failure(exc: BaseException, home: str) -> None:
    """Before the temp home goes: the failing phase's name and exception,
    then the last lines of each .err file written since that phase began
    (by its processes, or by a process beside it)."""
    name, t0 = getattr(exc, "smoke_phase", ("main", _T0_WALL))
    print(f"chip_smoke: phase {name} failed: {type(exc).__name__}: {exc}", file=sys.stderr, flush=True)
    harvest_err_files(home)
    for work in WORK_DIRS:
        if os.path.isdir(work):
            harvest_err_files(work)
    for path, (mtime, tail) in sorted(ERR_TAILS.items(), key=lambda kv: kv[1][0]):
        if mtime >= t0 and tail.strip():
            print(f"chip_smoke: last lines of {path}:\n{tail.rstrip()}", file=sys.stderr, flush=True)


def smoke_storage(home: str):
    """The port's storage as the CLI's ``--home home`` opens it: without
    ``PIO_STORAGE_*`` in the environment, one sqlite file, home/pio.db."""
    from predictionio_tpu_torch.data.storage.registry import Storage

    return Storage(env={**os.environ, "PIO_FS_BASEDIR": home})


def synthesize_ratings(n_users: int, n_items: int, n_ratings: int, seed: int = 0):
    """The bench's synthetic ratings (bench.py:136): low-rank + noise with a
    zipf item popularity, quantised to half stars."""
    rng = np.random.default_rng(seed)
    users = rng.integers(0, n_users, n_ratings).astype(np.int32)
    items = (rng.zipf(1.3, n_ratings).astype(np.int64) % n_items).astype(np.int32)
    k = 8
    U = rng.normal(size=(n_users, k)) / np.sqrt(k)
    V = rng.normal(size=(n_items, k)) / np.sqrt(k)
    vals = np.clip(
        np.sum(U[users] * V[items], axis=1) + 3.0 + 0.3 * rng.normal(size=n_ratings),
        1.0,
        5.0,
    ).astype(np.float32)
    return users, items, (np.round(vals * 2.0) / 2.0).astype(np.float32)


def spd_batch(torch, n: int, f: int, seed: int, reg: float = 0.05):
    """ALS-shaped systems (tests/test_spd_solve.py:18): Gram of random data
    plus a scaled ridge, drawn on the card from a seeded generator (the
    host took 10 s and more to draw them at f = 256)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    G = torch.randn(n, 3 * f, f, generator=gen, device="cuda")
    A = G.mT @ G + reg * (3 * f) * torch.eye(f, device="cuda")
    return A.contiguous(), torch.randn(n, f, generator=gen, device="cuda")


def cg_bound_ms(n: int, f: int) -> tuple[float, str]:
    """Least time for B1's work: A and b read once, x written once, against
    the f32 operations of f+4 preconditioned CG steps (the port's analytic
    cost model, which ``pio doctor --roofline`` prints)."""
    from predictionio_tpu_torch.obs import costmodel

    ms, bound_by, _ = costmodel.bound_ms(costmodel.spd_cg_cost(n, f))
    return ms, bound_by


@phase
def profiler_warm_up(torch, home: str) -> None:
    """CUPTI's one-time set-up for this process, on its main thread while
    the card is idle (a first trace started on a serving thread under load
    took tens of seconds, and one started on a server's thread late in a
    long run recorded no kernel at all): every in-process server of the run
    then captures at once. A deploy process pays the set-up in its first
    capture (``sequential_captures``: the set-up runs while no query is
    sent)."""
    from predictionio_tpu_torch.obs.profiler import ProfileSession, ProfileStore

    session = ProfileSession(ProfileStore(os.path.join(home, "warmup_profiles")), device="cuda")
    t0 = time.perf_counter()
    session.warm_up()
    if not session.ready:
        raise AssertionError("torch.profiler's warm-up recorded no kernel on the card")
    emit_numbers("profiler_warm_up", seconds=time.perf_counter() - t0)


@phase
def doctor_start(home: str) -> dict:
    """Start ``pio doctor`` in four processes (they run beside the next
    phase; :func:`doctor_phase` reads them)."""
    cli, env, _ = _cli(home)
    argvs = {"inventory": ["doctor"],
             "capacity": ["doctor", "--capacity", "138000", "27000", "32", "--ann", "2048,16"],
             "capacity_mesh": ["doctor", "--capacity", "138000", "27000", "32", "--mesh", "data=2",
                               "--gather-dtype", "bf16"],
             "roofline": ["doctor", "--roofline"]}
    return {k: subprocess.Popen([*cli, *a], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for k, a in argvs.items()}


@phase
def doctor_phase(torch, procs: dict) -> dict:
    """``pio doctor``'s four processes: the inventory names the card;
    ``--capacity 138000 27000 32 --ann 2048,16`` prices the ML-20M train
    beside the train's measured torch.cuda.max_memory_allocated (``--mesh
    data=2 --gather-dtype bf16`` prices the 2-rank train, read by
    :func:`doctor_mesh_check`);
    ``--roofline`` prints B1/B2/B3's bounds at PERF.md's shapes, equal to
    the kernel table's."""
    t0 = time.perf_counter()
    outs = {}
    for k, proc in procs.items():
        out, err = proc.communicate(timeout=300)
        if proc.returncode != 0:
            raise AssertionError(f"pio doctor {k} exited {proc.returncode}: {err[-2000:]}")
        outs[k] = out
    wait = time.perf_counter() - t0
    name = torch.cuda.get_device_name(0)
    if name not in outs["inventory"]:
        raise AssertionError(f"pio doctor's inventory does not name {name}:\n{outs['inventory']}")
    capacity = json.loads(outs["capacity"])
    bounds = {}
    for line in outs["roofline"].splitlines():
        if line.startswith("bound "):
            _, kernel, rest = line.split(None, 2)
            shape, _, tail = rest.partition("}")
            ms = float(tail.split()[0])
            bounds[(kernel, tuple(sorted(json.loads(shape + "}").items())))] = ms
    wrong = {k: (bounds.get(k), v) for k, v in TABLE_BOUNDS.items()
             if k not in bounds or round(bounds[k], v[1]) != v[0]}
    if wrong:
        raise AssertionError(f"pio doctor --roofline against the kernel table: {wrong}")
    measured = PEAKS["als_train_ml20m"]
    steps = {"capacity_factor_bytes": capacity["capacity"]["factor_bytes"],
             "capacity_workspace_bytes": capacity["capacity"]["workspace_bytes"],
             "capacity_per_device_bytes": capacity["capacity"]["per_device_bytes"],
             "ann_index_bytes": capacity["ann"]["perDeviceBytes"],
             "capacity_total_bytes": capacity["perDeviceBytesTotal"],
             "measured_train_peak_bytes": measured,
             "estimate_over_measured": capacity["capacity"]["per_device_bytes"] / measured,
             "roofline_bounds_checked": len(TABLE_BOUNDS), "doctor_wait_s": wait,
             "mesh_capacity": json.loads(outs["capacity_mesh"])["capacity"]}
    if steps["mesh_capacity"]["n_devices"] != 2:
        raise AssertionError(f"pio doctor --mesh data=2 priced {steps['mesh_capacity']}")
    emit_numbers("doctor", **{k: v for k, v in steps.items() if k != "mesh_capacity"})
    return steps


@phase
def doctor_mesh_check(doctor: dict, ranks: dict) -> None:
    """pio doctor --capacity 138000 27000 32 --mesh data=2 --gather-dtype
    bf16 beside each rank's max_memory_allocated in sharded_als's 2-rank
    train (f32 gathers; the estimate adds the bf16 copies)."""
    est = doctor["mesh_capacity"]
    peaks = ranks["sharded_als"].pop("peaks_w2")
    emit(phase="doctor_mesh", gpu=GPU, per_device_bytes=est["per_device_bytes"],
         factor_bytes=est["factor_bytes"], workspace_bytes=est["workspace_bytes"],
         measured_rank_peaks=peaks, estimate_over_measured=[est["per_device_bytes"] / p for p in peaks])


@phase
def kernel_phase(torch) -> None:
    """B1 against its plain version: ranks 10..100 (atol 1e-4), and past
    rank 128, one block per system with A in shared memory (160) and read
    from device memory (256), row-relative 1e-4."""
    from predictionio_tpu_torch.ops.spd_solve import _cg_body, batched_spd_solve_fused, launch_plan

    for f in (10, 16, 32, 64, 100, 160, 256):
        n = 1000 + 7 * f + 3  # not a multiple of any tile
        A_d, b_d = spd_batch(torch, n, f, seed=f)
        x = batched_spd_solve_fused(A_d, b_d)
        ref = _cg_body(A_d, b_d, f + 4)
        torch.cuda.synchronize()
        err = float((x - ref).abs().max())
        row_rel = float(((x - ref).norm(dim=1) / ref.norm(dim=1).clamp(min=1e-30)).max())
        # atol 1e-4: the same f32 algorithm, summed in another order over f+4 steps
        ok = err <= 1e-4 if f <= 128 else row_rel <= 1e-4
        if not (torch.isfinite(x).all() and ok):
            raise AssertionError(f"B1 disagrees with _cg_body at f={f}: max abs err {err}, "
                                 f"row-relative {row_rel}")
        emit(phase="kernel", kernel="spd_cg", n=n, f=f, plan=launch_plan(f).kernel,
             max_abs_err=err, max_row_rel_err=row_rel,
             limit={"atol": 1e-4} if f <= 128 else {"row_rel": 1e-4})


@phase
def kernel_grid_phase(torch) -> dict:
    """B1 past f = 11,619 (the grid plan, vectors in a device scratch
    buffer): one system at f = 11,700 (A 548 MB, M Mᵀ/f + 0.5 I from a seeded
    generator on the card) against the plain version at row-relative 1e-3,
    each timed once beside the library Cholesky, eager and as one captured
    call of a CUDA graph (or the reason the capture failed)."""
    from predictionio_tpu_torch.ops.spd_solve import _cg_body, batched_spd_solve_fused, launch_plan
    from predictionio_tpu_torch.utils.cuda_timing import event_ms, graph_ms

    f = 11_700
    gen = torch.Generator(device="cuda").manual_seed(11)
    M = torch.randn(f, f, generator=gen, device="cuda")
    A = (M @ M.T / f + 0.5 * torch.eye(f, device="cuda"))[None].contiguous()
    del M
    b = torch.randn(1, f, generator=gen, device="cuda")
    x = batched_spd_solve_fused(A, b)
    ref = _cg_body(A, b, f + 4)
    row_rel = float(((x - ref).norm(dim=1) / ref.norm(dim=1)).max())
    if not (torch.isfinite(x).all() and row_rel <= 1e-3):
        raise AssertionError(f"B1 at f = {f}: row-relative error {row_rel} against _cg_body")

    def library():
        L, _ = torch.linalg.cholesky_ex(A)
        return torch.linalg.solve_triangular(
            L.mT, torch.linalg.solve_triangular(L, b[..., None], upper=False), upper=True)

    def graphed(fn) -> tuple[float | None, str | None]:
        # one call captured and replayed once: a call is seconds long here
        try:
            return graph_ms(fn, launches=1, replays=1, warmup=1), None
        except Exception as exc:  # noqa: BLE001 - a timing, reported with its cause
            torch.cuda.synchronize()
            return None, f"{type(exc).__name__}: {exc}"

    bound_ms, bound_by = cg_bound_ms(1, f)
    graph, graph_error = graphed(lambda: batched_spd_solve_fused(A, b))
    library_graph, library_graph_error = graphed(library)
    row = {"systems": "one system past the block limit", "n": 1, "f": f,
           "plan": launch_plan(f).kernel, "max_abs_err": float((x - ref).abs().max()),
           "max_row_rel_err": row_rel,
           "ms": event_ms(lambda: batched_spd_solve_fused(A, b), reps=1, warmup=0),
           "graph_ms": graph, "graph_error": graph_error,
           "plain_ms": event_ms(lambda: _cg_body(A, b, f + 4), reps=1, warmup=0),
           "library_ms": event_ms(library, reps=1, warmup=1),
           "library_graph_ms": library_graph, "library_graph_error": library_graph_error,
           "bound_ms": bound_ms, "bound_by": bound_by}
    emit(phase="kernel_real", kernel="spd_cg", **row)
    return row


@phase
def train_phase(torch, home: str):
    from predictionio_tpu_torch.models.recommendation.engine import (
        ALSAlgorithm,
        ALSAlgorithmParams,
        TrainingData,
    )
    from predictionio_tpu_torch.ops import als as als_ops
    from predictionio_tpu_torch.ops.spd_solve import batched_spd_solve_fused
    from predictionio_tpu_torch.utils import native
    from predictionio_tpu_torch.workflow.context import WorkflowContext

    n_users, n_items, n_ratings, rank, iterations = 138_000, 27_000, 20_000_000, 32, 10
    t0 = time.perf_counter()
    users, items, vals = synthesize_ratings(n_users, n_items, n_ratings)
    test_mask = np.random.default_rng(42).random(n_ratings) < 0.02
    td = TrainingData(
        users[~test_mask], items[~test_mask], vals[~test_mask],
        [f"u{i}" for i in range(n_users)], [f"i{i}" for i in range(n_items)],
    )
    data_s = time.perf_counter() - t0
    algo = ALSAlgorithm(
        ALSAlgorithmParams(rank=rank, num_iterations=iterations, lambda_=0.05, chunk=65536)
    )
    algo.timings = {}
    ctx = WorkflowContext(device="cuda", _storage=smoke_storage(home))
    batched_spd_solve_fused.launches = 0
    grouped_before = native.calls["coo_group"]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = algo.train(ctx, td)
    train_wall_s = time.perf_counter() - t0
    PEAKS["als_train_ml20m"] = torch.cuda.max_memory_allocated()
    launches = batched_spd_solve_fused.launches
    if native.calls["coo_group"] == grouped_before:
        raise AssertionError("the ML-20M train did not group its ratings through the host library")
    pred = np.sum(model.user_factors[users[test_mask]] * model.item_factors[items[test_mask]], 1)
    rmse = float(np.sqrt(np.mean((pred - vals[test_mask]) ** 2)))
    # the train's user-side group-by (the host library's counting sort)
    # against its plain version, numpy's stable argsort, on the same ratings
    t0 = time.perf_counter()
    grouped = als_ops._host_group_by(td.user_idx, td.item_idx, td.ratings, n_users)
    group_by_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain = als_ops._host_group_by_plain(td.user_idx, td.item_idx, td.ratings, n_users)
    group_by_plain_s = time.perf_counter() - t0
    for name, got, want in zip(("cols", "vals", "deg"), grouped, plain):
        if got.dtype != want.dtype or not np.array_equal(got, want):
            raise AssertionError(f"the host library's group-by differs from numpy's stable argsort in {name}")
    del grouped, plain
    emit(
        phase="train", shape=[n_users, n_items, n_ratings], rank=rank,
        iterations=iterations, data_s=data_s, train_wall_s=train_wall_s,
        **{k: algo.timings.get(k) for k in ("pack_s", "upload_s", "build_s", "device_s")},
        group_by_s=group_by_s, group_by_numpy_s=group_by_plain_s, group_by_bit_equal=True,
        timings=algo.timings, heldout_rmse=rmse, rmse_gate=0.45, spd_cg_launches=launches,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
    )
    ONE_RANK_ALS.update(user_factors=model.user_factors, item_factors=model.item_factors, rmse=rmse,
                        ratings=(users, items, vals, test_mask))
    if not rmse <= 0.45:
        raise AssertionError(f"held-out RMSE {rmse} above the 0.45 gate")
    if launches != 2 * iterations:
        raise AssertionError(f"B1 launched {launches} times, expected {2 * iterations}")
    return td, model, algo.params, launches


def b1_times(torch, A, b) -> dict:
    """B1 on A [n, f, f], b [n, f], timed beside its plain version and the
    library Cholesky: ``ms`` by CUDA events over eager calls (host cost
    included), ``graph_ms`` the device time per launch from a replayed CUDA
    graph, and the same two for the library."""
    from predictionio_tpu_torch.ops.spd_solve import _cg_body, batched_spd_solve_fused
    from predictionio_tpu_torch.utils.cuda_timing import event_ms, graph_ms

    n, f = b.shape

    def kernel():
        return batched_spd_solve_fused(A, b)

    def library():
        # cholesky_ex checks nothing on the host, and two triangular solves
        # replace cholesky_solve, whose batched path allocates device memory
        # on every call and so cannot be captured into a CUDA graph
        L, _ = torch.linalg.cholesky_ex(A)
        y = torch.linalg.solve_triangular(L, b[..., None], upper=False)
        return torch.linalg.solve_triangular(L.mT, y, upper=True)

    bound_ms, bound_by = cg_bound_ms(n, f)
    return {
        "n": n, "f": f, "ms": event_ms(kernel, reps=20), "graph_ms": graph_ms(kernel),
        "plain_ms": event_ms(lambda: _cg_body(A, b, f + 4), reps=5),
        "library_ms": event_ms(library, reps=5),
        "library_graph_ms": graph_ms(library, launches=3, replays=3),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }


def b1_errors(torch, A, b) -> tuple[float, float]:
    """Max abs and max row-relative difference of B1 from the plain version."""
    from predictionio_tpu_torch.ops.spd_solve import _cg_body, batched_spd_solve_fused

    x = batched_spd_solve_fused(A, b)
    ref = _cg_body(A, b, b.shape[1] + 4)
    torch.cuda.synchronize()
    if not torch.isfinite(x).all():
        raise AssertionError(f"B1 gave non-finite values on {tuple(A.shape)}")
    row_rel = (x - ref).norm(dim=1) / ref.norm(dim=1).clamp(min=1e-30)
    return float((x - ref).abs().max()), float(row_rel.max())


def order_spread(torch, A, b, orders: int = 8):
    """Per system, how far the plain version's answer moves when only its
    rounding order changes: the largest row-relative distance, over
    ``orders`` seeded permutations of the coordinates, between the plain
    solve of the permuted system (permuted back) and that of A, b."""
    from predictionio_tpu_torch.ops.spd_solve import _cg_body

    f = b.shape[1]
    ref = _cg_body(A, b, f + 4)
    gen = torch.Generator().manual_seed(0)
    spread = torch.zeros(b.shape[0], device=b.device)
    for _ in range(orders):
        p = torch.randperm(f, generator=gen).to(b.device)
        x = torch.empty_like(b)
        x[:, p] = _cg_body(A[:, p][:, :, p].contiguous(), b[:, p].contiguous(), f + 4)
        spread = torch.maximum(spread, (x - ref).norm(dim=1) / ref.norm(dim=1).clamp(min=1e-30))
    return spread


def b1_rows_held(torch, A, b, row_rel_limit: float, what: str, x=None, ref=None) -> dict:
    """Holds B1 to its plain version on every one of the systems A, b, and
    raises on any row outside. A row passes within row-relative
    ``row_rel_limit`` of the plain answer. f32 CG at f+4 steps does not
    converge on some ALS systems (few ratings, a small lambda), and there
    the plain answer itself moves by up to a tenth of a row when only its
    rounding order changes. A row past the limit passes only if the plain
    version does not determine it either (``order_spread`` above a tenth of
    the limit) and B1's row is within 1.5x the plain version's largest row
    distance from the float64 solution; B1's mean distance must also be
    within 1.25x the plain version's. ``x``: B1's answer from a launch the
    caller made (none is made here then); ``ref``: the plain version's
    answer, when the caller has it. Returns the check's record."""
    from predictionio_tpu_torch.ops.spd_solve import _cg_body, batched_spd_solve_fused

    if x is None:
        x = batched_spd_solve_fused(A, b)
    if ref is None:
        ref = _cg_body(A, b, b.shape[1] + 4)
    torch.cuda.synchronize()
    if not torch.isfinite(x).all():
        raise AssertionError(f"B1 gave non-finite values on {what}")
    row_rel = (x - ref).norm(dim=1) / ref.norm(dim=1).clamp(min=1e-30)
    limit = {"row_rel": row_rel_limit}
    record = {"max_abs_err": float((x - ref).abs().max()), "max_row_rel_err": float(row_rel.max()),
              "limit": limit}
    off = row_rel > row_rel_limit
    if not off.any():
        return record
    spread = order_spread(torch, A[off], b[off])
    exact = torch.linalg.solve(A.double(), b.double().unsqueeze(-1)).squeeze(-1)

    def to_exact(v):
        return (v.double() - exact).norm(dim=1) / exact.norm(dim=1).clamp(min=1e-30)

    kernel_err, plain_err = to_exact(x), to_exact(ref)
    limit.update({
        "rows": int(b.shape[0]), "rows_past_row_rel": int(off.sum()),
        "their_min_order_spread": float(spread.min()), "determined_below": row_rel_limit / 10,
        "f64_row_err_bound": 1.5 * float(plain_err.max()),
        "kernel_max_f64_row_err_there": float(kernel_err[off].max()),
        "plain_max_f64_row_err": float(plain_err.max()),
        "kernel_mean_f64_row_err": float(kernel_err.mean()),
        "plain_mean_f64_row_err": float(plain_err.mean()),
    })
    if (spread <= row_rel_limit / 10).any() \
            or limit["kernel_max_f64_row_err_there"] > limit["f64_row_err_bound"] \
            or limit["kernel_mean_f64_row_err"] > 1.25 * limit["plain_mean_f64_row_err"]:
        raise AssertionError(f"B1 on {what}: {limit}")
    return record


REFINED_F64_LIMIT = 1e-6  # B1's row against float64 where f32 CG converged
CONVERGED_F64 = 1e-5  # the plain version's row against float64 there


def b1_refinement_held(torch, A, b, x, ref, what: str) -> dict:
    """Holds the register plan (f <= 64) to what its refinement step is
    for: on every row that the plain version solves to within row-relative
    1e-5 of float64 (f32 CG at f + 4 steps converged there), B1's row ``x``
    is within 1e-6 of float64, and B1's mean float64 row error is at most
    the plain version's. Where f32 CG converges slowly, one refinement
    step does not reach float64 (ML-100K item systems at lambda 0.01, on
    an H100: a row the plain version solved to 1e-4 came out 3.9e-6 off),
    so such rows are held only through that mean, and by
    ``b1_rows_held``. ``ref``: the plain version's answer. Raises on a row
    outside; returns the check's record."""
    exact = torch.linalg.solve(A.double(), b.double().unsqueeze(-1)).squeeze(-1)
    norm = exact.norm(dim=1).clamp(min=1e-30)
    kernel_err = (x.double() - exact).norm(dim=1) / norm
    plain_err = (ref.double() - exact).norm(dim=1) / norm
    converged = plain_err <= CONVERGED_F64
    record = {
        "rows": int(b.shape[0]), "rows_converged": int(converged.sum()),
        "kernel_max_f64_row_err_converged": float(kernel_err[converged].max()) if converged.any() else 0.0,
        "kernel_max_f64_row_err": float(kernel_err.max()),
        "kernel_mean_f64_row_err": float(kernel_err.mean()),
        "plain_mean_f64_row_err": float(plain_err.mean()),
        "limit": {"f64_row_err_converged": REFINED_F64_LIMIT, "converged_below": CONVERGED_F64},
    }
    if not record["kernel_max_f64_row_err_converged"] <= REFINED_F64_LIMIT \
            or not record["kernel_mean_f64_row_err"] <= record["plain_mean_f64_row_err"]:
        raise AssertionError(f"B1's refinement on {what}: {record}")
    return record


def b1_held(torch, A, b, row_rel_limit: float, what: str, x=None) -> dict:
    """``b1_rows_held``, and in the register plan (f <= 64, the plan that
    refines) also ``b1_refinement_held``, whose record goes under
    ``refined``. ``x``: B1's answer from the caller's own launch."""
    from predictionio_tpu_torch.ops.spd_solve import _cg_body, batched_spd_solve_fused, launch_plan

    if x is None:
        x = batched_spd_solve_fused(A, b)
    ref = _cg_body(A, b, b.shape[1] + 4)
    record = b1_rows_held(torch, A, b, row_rel_limit, what, x=x, ref=ref)
    if launch_plan(b.shape[1]).kernel == "registers":
        record["refined"] = b1_refinement_held(torch, A, b, x, ref, what)
    return record


@phase
def real_system_check(torch, td, model, params, launches: int, row_rel_limit: float = 1e-3,
                      label: str = "ML-20M", synthetic: bool = True,
                      timed: bool = True) -> tuple[list, dict | None]:
    """B1 on the real user-side and item-side systems of the model trained
    with ``params`` (ALSAlgorithmParams), each row held to the plain version
    by ``b1_rows_held`` and, with ``timed``, timed beside it and the library
    Cholesky; with ``synthetic``, also on 138,001 seeded rank-10 systems
    (the template default). Returns every row, and B1's entry of the
    kernels line with the user side as its shape (None when not timed)."""
    from predictionio_tpu_torch.ops.als import ALSConfig, _normal_system, pack_tables

    n_users, n_items = len(td.user_vocab), len(td.item_vocab)
    cfg = ALSConfig(rank=model.user_factors.shape[1], reg=params.lambda_, chunk=params.chunk)
    tables, block_chunk = pack_tables(
        td.user_idx, td.item_idx, td.ratings, n_users, n_items, cfg, "cuda"
    )
    factors = {}
    for side, trained, rows in (("item", model.item_factors, n_items),
                                ("user", model.user_factors, n_users)):
        factors[side] = torch.zeros(rows + 1, cfg.rank, device="cuda")
        factors[side][:rows] = torch.from_numpy(trained).cuda()
    rows = []
    for side, k, opposite, n_side in (("user", 0, "item", n_users), ("item", 4, "user", n_items)):
        A, b = _normal_system(*tables[k : k + 4], factors[opposite], n_side + 1, block_chunk,
                              cfg.reg, False, 1.0, True)
        held = b1_held(torch, A, b, row_rel_limit, f"the {label} {side} side")
        rows.append({"systems": f"{label} {side} side", "n": int(b.shape[0]), "f": int(b.shape[1]), **held,
                     **(b1_times(torch, A, b) if timed else {})})
        del A, b
    del tables
    if synthetic:
        A, b = spd_batch(torch, n_users + 1, 10, seed=10)
        abs_err, row_rel = b1_errors(torch, A, b)
        if not abs_err <= 1e-4:  # the kernel phase's limit on these systems
            raise AssertionError(f"B1 on {n_users + 1} rank-10 systems: max abs err {abs_err}")
        rows.append({"systems": "spd_batch, template default rank", "max_abs_err": abs_err,
                     "max_row_rel_err": row_rel, **b1_times(torch, A, b)})
    for row in rows:
        emit(phase="kernel_real", kernel="spd_cg", **row)
    if not timed:
        return rows, None
    user = rows[0]
    return rows, {
        "name": "spd_cg",
        "route": "cuda",
        "source": SOURCE,
        "replaces": REPLACES,
        "launches": launches,
        **{key: user[key] for key in ("max_abs_err", "ms", "graph_ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms", "library_graph_ms")},
        "shape": [user["n"], user["f"]],
        "other_shapes": rows[1:],
    }


@phase
def als_rank160_phase(torch, home: str) -> tuple[dict, int]:
    """ALSAlgorithm.train at rank 160 (B1 past rank 128: one block per
    system, A in shared memory) on the ML-1M shape, B1's launches read
    around it; then B1 on the trained model's user-side systems against the
    plain version (row-relative 1e-3) and timed, and on 2,048 seeded
    rank-256 systems (A read from device memory)."""
    from predictionio_tpu_torch.models.recommendation.engine import (
        ALSAlgorithm,
        ALSAlgorithmParams,
        TrainingData,
    )
    from predictionio_tpu_torch.ops.als import ALSConfig, _normal_system, pack_tables
    from predictionio_tpu_torch.ops.spd_solve import batched_spd_solve_fused
    from predictionio_tpu_torch.workflow.context import WorkflowContext

    n_users, n_items, n_ratings, rank, iterations = 6040, 3706, 1_000_209, 160, 5
    users, items, vals = synthesize_ratings(n_users, n_items, n_ratings, seed=3)
    test_mask = np.random.default_rng(43).random(n_ratings) < 0.02
    td = TrainingData(users[~test_mask], items[~test_mask], vals[~test_mask],
                      [f"u{i}" for i in range(n_users)], [f"i{i}" for i in range(n_items)])
    algo = ALSAlgorithm(ALSAlgorithmParams(rank=rank, num_iterations=iterations, lambda_=0.05,
                                           chunk=65536))
    ctx = WorkflowContext(device="cuda", _storage=smoke_storage(home))
    batched_spd_solve_fused.launches = 0
    t0 = time.perf_counter()
    model = algo.train(ctx, td)
    train_wall_s = time.perf_counter() - t0
    launches = batched_spd_solve_fused.launches
    pred = np.sum(model.user_factors[users[test_mask]] * model.item_factors[items[test_mask]], 1)
    rmse = float(np.sqrt(np.mean((pred - vals[test_mask]) ** 2)))
    if launches != 2 * iterations or not np.isfinite(rmse):
        raise AssertionError(f"rank-160 ALS: B1 launched {launches} times (expected "
                             f"{2 * iterations}), held-out RMSE {rmse}")
    cfg = ALSConfig(rank=rank, reg=0.05, chunk=65536)
    tables, block_chunk = pack_tables(td.user_idx, td.item_idx, td.ratings, n_users, n_items,
                                      cfg, "cuda")
    items_f = torch.zeros(n_items + 1, rank, device="cuda")
    items_f[:n_items] = torch.from_numpy(model.item_factors).cuda()
    A, b = _normal_system(*tables[0:4], items_f, n_users + 1, block_chunk, cfg.reg, False, 1.0, True)
    abs_err, row_rel = b1_errors(torch, A, b)
    if not row_rel <= 1e-3:
        raise AssertionError(f"B1 at rank 160 on the user side: row-relative error {row_rel}")
    row = {"systems": "ML-1M user side, rank 160", "max_abs_err": abs_err,
           "max_row_rel_err": row_rel, **b1_times(torch, A, b)}
    del A, b, tables
    A, b = spd_batch(torch, 2048, 256, seed=256)
    abs_err256, row_rel256 = b1_errors(torch, A, b)
    if not row_rel256 <= 1e-4:
        raise AssertionError(f"B1 on 2,048 rank-256 systems: row-relative error {row_rel256}")
    row256 = {"systems": "spd_batch, rank 256", "max_abs_err": abs_err256,
              "max_row_rel_err": row_rel256, **b1_times(torch, A, b)}
    emit(phase="als_rank160", shape=[n_users, n_items, n_ratings], rank=rank,
         iterations=iterations, train_wall_s=train_wall_s, heldout_rmse=rmse,
         spd_cg_launches=launches)
    for r in (row, row256):
        emit(phase="kernel_real", kernel="spd_cg", **r)
    return {"rows": [row, row256]}, launches


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _http(url: str, payload=None, timeout: float = 30.0):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        body = json.loads(resp.read())
        return resp.status, body, time.perf_counter() - t0


def _check_result(body, num: int, n_items: int, banned=()) -> None:
    scores = body["itemScores"]
    if len(scores) != min(num, n_items):
        raise AssertionError(f"expected {num} itemScores, got {len(scores)}")
    for s in scores:
        if not (isinstance(s["item"], str) and np.isfinite(s["score"])):
            raise AssertionError(f"malformed itemScore {s}")
        if s["item"] in banned:
            raise AssertionError(f"blacklisted item {s['item']} served")
    got = [s["score"] for s in scores]
    if got != sorted(got, reverse=True):
        raise AssertionError("itemScores not in descending order")


def _cli(home: str):
    """The port's CLI command line for ``home``, its environment, and a
    runner that returns a verb's wall seconds and raises if it fails."""
    env = {**os.environ, "PYTHONPATH": os.path.dirname(os.path.abspath(__file__))}
    cli = [sys.executable, "-m", "predictionio_tpu_torch.tools.cli", "--home", home]

    def run(*args, timeout=600):
        t0 = time.perf_counter()
        proc = subprocess.run([*cli, *args], env=env, capture_output=True, text=True, timeout=timeout)
        if proc.returncode != 0:
            raise AssertionError(f"cli {args[0]} failed ({proc.returncode}):\n{proc.stderr}")
        return time.perf_counter() - t0

    return cli, env, run


def _start_deploy(cli, env, engine_dir, work, device, name="deploy", extra=()):
    port = _free_port()
    with open(os.path.join(work, f"{name}.err"), "w") as err:  # the child keeps its own copy
        server = subprocess.Popen(
            [*cli, "deploy", "--engine-dir", engine_dir, "--device", device,
             "--ip", "127.0.0.1", "--port", str(port), *extra],
            env=env, stdout=subprocess.DEVNULL, stderr=err,
        )
    base = f"http://127.0.0.1:{port}"
    t0 = time.perf_counter()
    while True:
        if server.poll() is not None:
            with open(os.path.join(work, f"{name}.err")) as fh:
                raise AssertionError(f"deploy exited {server.returncode}: {fh.read()}")
        try:
            status, _, _ = _http(base + "/", timeout=2)
            if status == 200:
                return server, base, time.perf_counter() - t0
        except (urllib.error.URLError, ConnectionError, TimeoutError):
            pass
        if time.perf_counter() - t0 > 180:
            server.kill()
            server.wait()
            raise AssertionError("deploy did not answer GET / within 180 s")
        time.sleep(0.2)


def _stop(server) -> None:
    server.send_signal(signal.SIGTERM)
    try:
        server.wait(timeout=30)
    except subprocess.TimeoutExpired:
        server.kill()
        server.wait()


@phase
def cli_serve_phase(home: str, device: str = "cuda") -> dict:
    """app new -> import -> train -> deploy through the port's CLI, then
    POST /queries.json: a concurrent burst, an unknown user, a blacklist.
    The ML-100K shape's users and items with half its ratings (50,000)."""
    n_users, n_items, n_ratings = 943, 1682, 50_000
    users, items, vals = synthesize_ratings(n_users, n_items, n_ratings, seed=1)
    work = work_dir(prefix="pio_smoke_cli_")
    events = os.path.join(work, "events.jsonl")
    with open(events, "w") as fh:
        for k, (u, i, r) in enumerate(zip(users.tolist(), items.tolist(), vals.tolist())):
            fh.write(json.dumps({
                "event": "rate", "entityType": "user", "entityId": f"u{u}",
                "targetEntityType": "item", "targetEntityId": f"i{i}",
                "properties": {"rating": r},
                "eventTime": f"2024-01-01T00:{k // 6000 % 60:02d}:{k // 100 % 60:02d}.{k % 100:03d}Z",
            }) + "\n")
    engine_dir = os.path.join(work, "engine")
    os.makedirs(engine_dir)
    with open(os.path.join(engine_dir, "engine.json"), "w") as fh:
        json.dump({
            "id": "smoke-rec",
            "engineFactory": "predictionio_tpu_torch.models.recommendation.engine.engine_factory",
            "datasource": {"params": {"appName": "smokeapp"}},
            "algorithms": [{"name": "als", "params": {
                "rank": 32, "numIterations": 10, "lambda": 0.05, "seed": 3}}],
        }, fh)
    cli, env, run = _cli(home)

    steps = {
        "app_new_s": run("app", "new", "smokeapp"),
        "import_s": run("import", "--appname", "smokeapp", "--input", events),
        "train_s": run("train", "--engine-dir", engine_dir, "--device", device),
    }
    server, base, steps["deploy_ready_s"] = _start_deploy(cli, env, engine_dir, work, device)
    try:
        latencies = []
        banned = [f"i{i}" for i in range(0, 40)]
        checks = [({"user": "u1", "num": 4}, 4, ()),
                  ({"user": "u2"}, 10, ()),
                  ({"user": "u3", "num": 20, "blackList": banned}, 20, banned)]
        for payload, num, bl in checks:
            status, body, dt = _http(base + "/queries.json", payload)
            if status != 200:
                raise AssertionError(f"{payload} answered {status}")
            _check_result(body, num, n_items, bl)
            latencies.append(dt)
        status, body, dt = _http(base + "/queries.json", {"user": "no-such-user", "num": 5})
        if status != 200 or body != {"itemScores": []}:
            raise AssertionError(f"unknown user answered {status} {body}")
        latencies.append(dt)
        largest = 0
        for burst in range(3):  # until the micro-batcher has batched a burst
            with concurrent.futures.ThreadPoolExecutor(32) as pool:
                outs = list(pool.map(
                    lambda u: _http(base + "/queries.json", {"user": f"u{u}", "num": 10}),
                    range(burst * 64, burst * 64 + 64),
                ))
            for status, body, dt in outs:
                if status != 200:
                    raise AssertionError(f"burst query answered {status}")
                _check_result(body, 10, n_items)
                latencies.append(dt)
            _, st, _ = _http(base + "/")
            largest = st["largestBatch"]
            if largest > 1:
                break
        if largest < 2:
            raise AssertionError("the micro-batcher never batched a concurrent burst")
        _, st, _ = _http(base + "/")
    finally:
        _stop(server)
        remove_work(work)
    lat_ms = np.asarray(latencies) * 1e3
    result = {
        **steps,
        "requests": len(latencies),
        "all_200": True,
        "p50_ms": float(np.percentile(lat_ms, 50)),
        "p99_ms": float(np.percentile(lat_ms, 99)),
        "largest_batch": largest,
        "batches": st["batches"],
        "queries": st["queries"],
    }
    emit(phase="serve_cli", shape=[n_users, n_items, n_ratings], **result)
    return result


# Runs the port's CLI in this process and, at its exit, writes to the path
# given as the first argument the kernel launches of the run (each count
# zeroed before the verb runs; train, deploy, batchpredict, eval, stream and
# lifecycle run), the calls into the host library (utils/native.py) and
# every module of JAX, the JAX package or aiohttp that the process imported.
_CLI_LAUNCHER = """
import atexit, json, runpy, sys
out = sys.argv.pop(1)
counted = bool({"train", "deploy", "batchpredict", "eval", "stream"} & set(sys.argv)) or (
    "lifecycle" in sys.argv and sys.argv[sys.argv.index("lifecycle") + 1:][:1] == ["run"])
if counted:
    from predictionio_tpu_torch.ops import attention, spd_solve
    kernels = {"spd_cg": spd_solve.batched_spd_solve_fused,
               "attention_block": attention.fused_attention_block,
               "flash_attention": attention.flash_attention}
    for fn in kernels.values():
        fn.launches = 0
def report():
    foreign = sorted(m for m in sys.modules if m.split(".")[0] in
                     ("jax", "jaxlib", "aiohttp", "predictionio_tpu"))
    launches = {k: fn.launches for k, fn in kernels.items()} if counted else {}
    calls = dict(sys.modules["predictionio_tpu_torch.utils.native"].calls) \
        if "predictionio_tpu_torch.utils.native" in sys.modules else {}
    with open(out, "w") as fh:
        json.dump({"launches": launches, "native_calls": calls, "foreign_modules": foreign}, fh)
atexit.register(report)
sys.argv[0] = "pio-torch"
runpy.run_module("predictionio_tpu_torch.tools.cli", run_name="__main__")
"""


@phase
def eventserver_phase(torch, home: str, device: str = "cuda") -> dict:
    """The ingest path as a user drives it, every verb a process of the
    port's CLI on one sqlite store: app new, accesskey new, eventserver;
    943 users x 1,682 items x 100,000 rate events from the seed posted in
    POST /batch/events.json requests of 50, then 1,000 single POST
    /events.json and one event at +08:00; every status 201; the counts
    through GET /events.json and /stats.json, the offset round trip. Then,
    with the event server still up, train (the engine.json default: rank
    10, 10 iterations, through B1) and deploy from that store, and 200
    queries, each answered 200 and well formed. B1 is held to its plain
    version on that train's user-side and item-side systems, read back
    from the store. Every process reports its kernel launches and that it
    imported nothing of JAX, the JAX package or aiohttp. Before the event
    server stops, :func:`serving_contract_cli_phase` runs on its store."""
    import http.client

    from predictionio_tpu_torch.controller.params import params_from_dict
    from predictionio_tpu_torch.models.recommendation import engine as rec
    from predictionio_tpu_torch.workflow import model_io
    from predictionio_tpu_torch.workflow.context import WorkflowContext
    from predictionio_tpu_torch.workflow.engine_loader import load_engine

    n_users, n_items, n_batch, n_single = 943, 1682, 100_000, 1_000
    users, items, vals = synthesize_ratings(n_users, n_items, n_batch + n_single, seed=9)
    work = work_dir(prefix="pio_smoke_rest_")
    env = {**os.environ, "PYTHONPATH": os.path.dirname(os.path.abspath(__file__))}
    reports = []

    def argv(*args):
        reports.append(os.path.join(work, f"report_{len(reports)}.json"))
        return [sys.executable, "-c", _CLI_LAUNCHER, reports[-1], "--home", home, *args]

    def run(*args):
        t0 = time.perf_counter()
        proc = subprocess.run(argv(*args), env=env, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"cli {args[0]} failed ({proc.returncode}):\n{proc.stderr}")
        return proc.stdout, time.perf_counter() - t0

    def start(name, *args):
        port = _free_port()
        err = open(os.path.join(work, f"{name}.err"), "w")
        proc = subprocess.Popen(argv(*args, "--ip", "127.0.0.1", "--port", str(port)), env=env,
                                stdout=subprocess.DEVNULL, stderr=err)
        err.close()
        t0 = time.perf_counter()
        while True:
            if proc.poll() is not None:
                with open(os.path.join(work, f"{name}.err")) as fh:
                    raise AssertionError(f"{name} exited {proc.returncode}: {fh.read()}")
            try:
                if _http(f"http://127.0.0.1:{port}/", timeout=2)[0] == 200:
                    return proc, port, time.perf_counter() - t0
            except (urllib.error.URLError, ConnectionError, TimeoutError):
                pass
            if time.perf_counter() - t0 > 180:
                _stop(proc)
                raise AssertionError(f"{name} did not answer GET / within 180 s")
            time.sleep(0.2)

    def when(k):
        return f"2024-02-{1 + k // 86_400:02d}T{k // 3600 % 24:02d}:{k // 60 % 60:02d}:{k % 60:02d}.000Z"

    def event(k):
        return {"event": "rate", "entityType": "user", "entityId": f"u{users[k]}",
                "targetEntityType": "item", "targetEntityId": f"i{items[k]}",
                "properties": {"rating": float(vals[k])}, "eventTime": when(k)}

    steps = {}
    _, steps["app_new_s"] = run("app", "new", "restapp")
    out, steps["accesskey_new_s"] = run("accesskey", "new", "restapp")
    key = out.strip().rsplit(" ", 1)[-1]
    server, es_port, steps["eventserver_ready_s"] = start("eventserver", "eventserver", "--stats")
    deploy = None
    try:
        conn = http.client.HTTPConnection("127.0.0.1", es_port, timeout=60)

        def call(method, path, body=None):
            t0 = time.perf_counter()
            conn.request(method, path, body=None if body is None else json.dumps(body).encode(),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            data = json.loads(resp.read())
            return resp.status, data, time.perf_counter() - t0

        batch_lat = []
        t0 = time.perf_counter()
        for lo in range(0, n_batch, 50):
            status, results, dt_s = call("POST", f"/batch/events.json?accessKey={key}",
                                         [event(k) for k in range(lo, lo + 50)])
            if status != 200 or any(r.get("status") != 201 for r in results):
                raise AssertionError(f"batch at {lo}: {status} {results[:2]}")
            batch_lat.append(dt_s)
        batch_wall = time.perf_counter() - t0
        single_lat = []
        for k in range(n_batch, n_batch + n_single):
            status, body, dt_s = call("POST", f"/events.json?accessKey={key}", event(k))
            if status != 201 or "eventId" not in body:
                raise AssertionError(f"single post {k}: {status} {body}")
            single_lat.append(dt_s)
        tz_event = {"event": "view", "entityType": "user", "entityId": "tz-user",
                    "targetEntityType": "item", "targetEntityId": "i1",
                    "eventTime": "2024-03-01T08:00:00.250+08:00"}
        status, body, _ = call("POST", f"/events.json?accessKey={key}", tz_event)
        if status != 201:
            raise AssertionError(f"the +08:00 event: {status} {body}")
        status, got, _ = call("GET", f"/events/{body['eventId']}.json?accessKey={key}")
        if status != 200 or got["eventTime"] != tz_event["eventTime"]:
            raise AssertionError(f"offset round trip: {status} {got}")
        t0 = time.perf_counter()
        status, listed, _ = call("GET", f"/events.json?accessKey={key}&limit=-1")
        list_all_s = time.perf_counter() - t0
        n_total = n_batch + n_single + 1
        if status != 200 or len(listed) != n_total:
            raise AssertionError(f"GET /events.json: {status}, {len(listed)} of {n_total} events")
        status, rated, _ = call("GET", f"/events.json?accessKey={key}&event=rate&entityType=user"
                                       f"&entityId=u{users[0]}&limit=-1")
        if status != 200 or len(rated) != int(np.sum(users == users[0])):
            raise AssertionError(f"one user's rate events: {status}, {len(rated)}")
        status, stats, _ = call("GET", f"/stats.json?accessKey={key}")
        if status != 200 or stats["longLive"]["statusCode"] != [{"status": 201, "count": n_total}]:
            raise AssertionError(f"/stats.json: {status} {stats.get('longLive')}")
        del listed
        conn.close()

        engine_dir = os.path.join(work, "engine")
        os.makedirs(engine_dir)
        with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "predictionio_tpu_torch/models/recommendation/engine.json")) as fh:
            variant = json.load(fh)
        variant["id"] = "smoke-rest"
        variant["datasource"]["params"]["appName"] = "restapp"
        with open(os.path.join(engine_dir, "engine.json"), "w") as fh:
            json.dump(variant, fh)
        _, steps["train_s"] = run("train", "--engine-dir", engine_dir, "--device", device)
        with open(reports[-1]) as fh:
            train_launches = json.load(fh)["launches"]["spd_cg"]
        algo_params = variant["algorithms"][0]["params"]
        if train_launches != 2 * algo_params["numIterations"]:
            raise AssertionError(f"pio train launched B1 {train_launches} times")
        deploy, q_port, steps["deploy_ready_s"] = start(
            "deploy", "deploy", "--engine-dir", engine_dir, "--device", device)
        base = f"http://127.0.0.1:{q_port}"
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            answers = list(pool.map(
                lambda u: _http(base + "/queries.json", {"user": f"u{u}", "num": 10}),
                np.unique(users)[:200].tolist()))
        query_wall = time.perf_counter() - t0
        for status, body, _ in answers:
            if status != 200:
                raise AssertionError(f"query answered {status}")
            _check_result(body, 10, n_items)
        contract_launches = serving_contract_cli_phase(
            work, argv, reports, run, es_port, engine_dir,
            [f"u{u}" for u in np.unique(users)[:200].tolist()], n_items, train_launches, device)
        profiled = profiled_train(work, run, reports, engine_dir, device)
    finally:
        for proc in (deploy, server):
            if proc is not None:
                _stop(proc)
    for path in reports:
        with open(path) as fh:
            foreign = json.load(fh)["foreign_modules"]
        if foreign:
            raise AssertionError(f"{os.path.basename(path)}: imported {foreign[:5]}")

    storage = smoke_storage(home)
    manifest, engine = load_engine(engine_dir)
    instance = storage.get_meta_data_engine_instances().get_latest_completed(
        manifest.engine_id, manifest.version, manifest.variant)
    (model,) = model_io.deserialize_models(storage.get_model_data_models().get(instance.id).models)
    ctx = WorkflowContext(device=device, _storage=storage)
    td = rec.DataSource(rec.DataSourceParams(app_name="restapp")).read_training(ctx)
    remove_work(work)
    kernel_rows, _ = real_system_check(
        torch, td, model, params_from_dict(rec.ALSAlgorithmParams, algo_params), train_launches,
        row_rel_limit=1e-4, label="ML-100K through the event server", synthetic=False)
    batch_ms = np.asarray(batch_lat) * 1e3
    q_ms = np.asarray([dt_s for _, _, dt_s in answers]) * 1e3
    result = {
        "host_numbers": True,
        **steps,
        "batch_requests": len(batch_lat),
        "batch_ingest_events_per_s": n_batch / batch_wall,
        "batch_request_p50_ms": float(np.percentile(batch_ms, 50)),
        "batch_request_p99_ms": float(np.percentile(batch_ms, 99)),
        "single_post_p50_ms": float(np.percentile(np.asarray(single_lat) * 1e3, 50)),
        "get_all_events_s": list_all_s,
        "events_stored": n_total,
        "train_spd_cg_launches": train_launches,
        "query_p50_ms": float(np.percentile(q_ms, 50)),
        "query_p99_ms": float(np.percentile(q_ms, 99)),
        "qps": len(answers) / query_wall,
        "queries_all_200": True,
    }
    emit(phase="eventserver", shape=[n_users, n_items, n_batch + n_single], **result)
    return {"launches": {"eventserver_train": train_launches, "serving_contract_cli": contract_launches,
                         "profile_train": profiled},
            "rows": kernel_rows,
            "variant": variant, "user_ids": sorted({f"u{u}" for u in users.tolist()} | {"tz-user"}),
            "access_key": key}


def _raw_responses(port: int, data: bytes, n: int, timeout: float = 10.0) -> list:
    """Send ``data`` on one connection and read up to ``n`` responses:
    [(status, decoded JSON body or None)]."""
    out = []
    with socket.create_connection(("127.0.0.1", port), timeout=timeout) as sock:
        sock.sendall(data)
        f = sock.makefile("rb")
        for _ in range(n):
            line = f.readline()
            if not line:
                break
            headers = {}
            while (h := f.readline()) not in (b"\r\n", b"\n", b""):
                k, v = h.decode("latin-1").split(":", 1)
                headers[k.strip().lower()] = v.strip()
            body = f.read(int(headers.get("content-length", "0")))
            json_body = headers.get("content-type", "").startswith("application/json")
            out.append((int(line.split()[1]), json.loads(body) if json_body else None))
    return out


def _chunked_request(path: str, payload, chunk: int = 16) -> bytes:
    body = json.dumps(payload).encode()
    return (f"POST {path} HTTP/1.1\r\nHost: 127.0.0.1\r\nContent-Type: application/json\r\n"
            "Transfer-Encoding: chunked\r\n\r\n").encode() + b"".join(
        f"{len(body[i:i + chunk]):x}\r\n".encode() + body[i:i + chunk] + b"\r\n"
        for i in range(0, len(body), chunk)) + b"0\r\n\r\n"


@phase
def sql_es_cli_phase(torch, home: str, device: str = "cuda", n_ratings: int = 100_000,
                     n_queries: int = 200) -> dict:
    """A deployment with its events in a SQL database and its metadata in
    Elasticsearch, every verb a process of the port's CLI: EVENTDATA is the
    generic ``sql`` type over sqlite3 (the DB-API code path, four scan
    partitions, one connection each), METADATA ``elasticsearch`` at
    tests/es_mock.py started as a process of its own, MODELDATA
    ``localfs``. The ML-100K shape (943 users x 1,682 items x 100,000 rate
    events at +08:00, seed 9): app new (its record in the mock) while the
    events file is written, import, train (rank 10, 10 iterations: 20 B1
    launches, read through the partitioned scan; beside it this process
    times the same scan), deploy, 200 queries and one chunked POST
    /queries.json on a keep-alive connection followed by GET / on it. The columnar arrays the train read, and the partitioned
    scan's, equal the imported ones in canonical order; B1 is held to its
    plain version on that train's systems; every answer equals serve_batch
    of the model read back from MODELDATA through the instance in
    METADATA; no process imported JAX, the JAX package or aiohttp. There
    is no fallback: a backend that does not connect fails the phase."""
    from predictionio_tpu_torch.controller.params import params_from_dict
    from predictionio_tpu_torch.data.storage.registry import Storage
    from predictionio_tpu_torch.models.recommendation import engine as rec
    from predictionio_tpu_torch.workflow import model_io
    from predictionio_tpu_torch.workflow.context import WorkflowContext
    from predictionio_tpu_torch.workflow.engine_loader import load_engine

    t_phase = time.perf_counter()
    n_users, n_items = 943, 1682
    users, items, vals = synthesize_ratings(n_users, n_items, n_ratings, seed=9)
    work = work_dir(prefix="pio_smoke_sqles_")
    root = os.path.dirname(os.path.abspath(__file__))
    procs: list = []
    reports: list = []

    def argv(*args):
        reports.append(os.path.join(work, f"report_{len(reports)}.json"))
        return [sys.executable, "-c", _CLI_LAUNCHER, reports[-1], "--home", home, *args]

    def start(args, **kw):
        procs.append(subprocess.Popen(args, **kw))
        return procs[-1]

    def finish(proc, what: str, t0: float) -> float:
        _, err = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"cli {what} failed ({proc.returncode}):\n{err}")
        return time.perf_counter() - t0

    steps: dict = {}
    try:
        # by path: a ``tests`` package installed in site-packages would
        # shadow the checkout's for ``python -m tests.es_mock``
        with open(os.path.join(work, "es_mock.err"), "w") as err:
            mock = start([sys.executable, os.path.join(root, "tests", "es_mock.py")], cwd=root,
                         stdout=subprocess.PIPE, stderr=err, text=True)
        es_url = mock.stdout.readline().strip()
        if not es_url.startswith("http://127.0.0.1:"):
            with open(os.path.join(work, "es_mock.err")) as fh:
                raise AssertionError(f"the Elasticsearch mock did not come up (exit {mock.poll()}): "
                                     f"{es_url!r} {fh.read()[-2000:]}")
        env = {
            **os.environ, "PYTHONPATH": root,
            "PIO_STORAGE_SOURCES_SQL_TYPE": "sql", "PIO_STORAGE_SOURCES_SQL_MODULE": "sqlite3",
            "PIO_STORAGE_SOURCES_SQL_PARTITIONS": "4",
            "PIO_STORAGE_SOURCES_SQL_CONNECT_ARGS": json.dumps({"database": os.path.join(work, "events.db")}),
            "PIO_STORAGE_SOURCES_ES_TYPE": "elasticsearch", "PIO_STORAGE_SOURCES_ES_URL": es_url,
            "PIO_STORAGE_SOURCES_FS_TYPE": "localfs", "PIO_STORAGE_SOURCES_FS_PATH": os.path.join(work, "models"),
            "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "SQL",
            "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "ES",
            "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "FS",
        }
        cli = dict(env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

        def run(*args) -> float:
            t0 = time.perf_counter()
            return finish(start(argv(*args), **cli), args[0], t0)

        t0 = time.perf_counter()
        app_new = start(argv("app", "new", "sqlapp"), **cli)
        events = os.path.join(work, "events.jsonl")
        with open(events, "w") as fh:
            for k in range(n_ratings):
                fh.write(json.dumps({
                    "event": "rate", "entityType": "user", "entityId": f"u{users[k]}",
                    "targetEntityType": "item", "targetEntityId": f"i{items[k]}",
                    "properties": {"rating": float(vals[k])},
                    "eventTime": f"2024-04-{1 + k // 86_400:02d}T{k // 3600 % 24:02d}:{k // 60 % 60:02d}:"
                                 f"{k % 60:02d}.000+08:00",
                }) + "\n")
        steps["app_new_s"] = finish(app_new, "app new", t0)
        steps["import_s"] = run("import", "--appname", "sqlapp", "--input", events)
        engine_dir = os.path.join(work, "engine")
        os.makedirs(engine_dir)
        with open(os.path.join(root, "predictionio_tpu_torch/models/recommendation/engine.json")) as fh:
            variant = json.load(fh)
        variant["id"] = "smoke-sql-es"
        variant["datasource"]["params"]["appName"] = "sqlapp"
        with open(os.path.join(engine_dir, "engine.json"), "w") as fh:
            json.dump(variant, fh)
        # the train, and beside it in this process the partitioned scan
        # itself, timed, with the train's filters (four partitions, one
        # connection each)
        storage = Storage(env={**env, "PIO_FS_BASEDIR": home})
        app_id = storage.get_meta_data_apps().get_by_name("sqlapp").id
        t0 = time.perf_counter()
        train = start(argv("train", "--engine-dir", engine_dir, "--device", device), **cli)
        cols = storage.get_p_events().to_columnar(app_id, event_names=["rate", "buy"], entity_type="user",
                                                  target_entity_type="item", rating_key="rating")
        partitioned_read_s = time.perf_counter() - t0
        steps["train_s"] = finish(train, "train", t0)
        with open(reports[-1]) as fh:
            train_launches = json.load(fh)["launches"].get("spd_cg", 0)
        algo_params = variant["algorithms"][0]["params"]
        if device == "cuda" and train_launches != 2 * algo_params["numIterations"]:
            raise AssertionError(f"pio train on sql launched B1 {train_launches} times")
        port = _free_port()
        t0 = time.perf_counter()
        with open(os.path.join(work, "deploy.err"), "w") as err:
            deploy = start(argv("deploy", "--engine-dir", engine_dir, "--device", device,
                                "--ip", "127.0.0.1", "--port", str(port)),
                           env=env, stdout=subprocess.DEVNULL, stderr=err)
        base = f"http://127.0.0.1:{port}"
        while True:
            if deploy.poll() is not None:
                with open(os.path.join(work, "deploy.err")) as fh:
                    raise AssertionError(f"deploy exited {deploy.returncode}: {fh.read()}")
            try:
                if _http(base + "/", timeout=2)[0] == 200:
                    break
            except (urllib.error.URLError, ConnectionError, TimeoutError):
                pass
            if time.perf_counter() - t0 > 180:
                raise AssertionError("deploy on sql/elasticsearch did not answer GET / within 180 s")
            time.sleep(0.2)
        steps["deploy_ready_s"] = time.perf_counter() - t0
        queried = [f"u{u}" for u in np.unique(users)[:n_queries].tolist()]
        outs, query_wall = _fleet_query_run(port, queried, clients=8)
        chunked = _raw_responses(port, _chunked_request("/queries.json", {"user": queried[0], "num": 10})
                                 + b"GET / HTTP/1.1\r\nHost: 127.0.0.1\r\nConnection: close\r\n\r\n", 2)
        if [c[0] for c in chunked] != [200, 200] or chunked[1][1].get("status") != "alive":
            raise AssertionError(f"a chunked query then GET / on one connection: {chunked}")
        _stop(deploy)
        if deploy.returncode != 0:
            raise AssertionError(f"deploy on sql/elasticsearch exited {deploy.returncode} on SIGTERM")
        # with the mock still up: the instance and model the deploy served,
        # and what the train read (its snapshot)
        manifest, _ = load_engine(engine_dir)
        instance = storage.get_meta_data_engine_instances().get_latest_completed(
            manifest.engine_id, manifest.version, manifest.variant)
        (model,) = model_io.deserialize_models(storage.get_model_data_models().get(instance.id).models)
        model.device = device
        td = rec.DataSource(rec.DataSourceParams(app_name="sqlapp")).read_training(
            WorkflowContext(device=device, _storage=storage))
    finally:
        for proc in procs:
            if proc.poll() is None:
                _stop(proc)
    for path in reports:
        with open(path) as fh:
            foreign = json.load(fh)["foreign_modules"]
        if foreign:
            raise AssertionError(f"sql_es_cli {os.path.basename(path)}: imported {foreign[:5]}")
    remove_work(work)
    # both reads against the imported arrays in canonical order (distinct
    # event times: the file's order; sorted vocabularies)
    user_vocab = sorted({f"u{u}" for u in users.tolist()})
    item_vocab = sorted({f"i{i}" for i in items.tolist()})
    want_u = np.searchsorted(np.asarray(user_vocab), np.asarray([f"u{u}" for u in users.tolist()]))
    want_i = np.searchsorted(np.asarray(item_vocab), np.asarray([f"i{i}" for i in items.tolist()]))
    for what, (vocab_u, vocab_i, u, i, r) in (
            ("the train's read", (td.user_vocab, td.item_vocab, td.user_idx, td.item_idx, td.ratings)),
            ("the partitioned scan", (cols.entity_vocab, cols.target_vocab, cols.entity_ids,
                                      cols.target_ids, cols.ratings))):
        if list(vocab_u) != user_vocab or list(vocab_i) != item_vocab or not np.array_equal(u, want_u) \
                or not np.array_equal(i, want_i) or not np.array_equal(np.asarray(r, dtype=np.float32), vals):
            raise AssertionError(f"sql_es_cli: {what} differs from the imported events")
    if chunked[0][1] is None:
        raise AssertionError(f"the chunked query's answer was not JSON: {chunked[0]}")
    _fleet_answers_held(model, outs + [(queried[0], 200, chunked[0][1], 0.0)], "sql_es_cli")
    rows = []
    if device == "cuda":
        rows, _ = real_system_check(
            torch, td, model, params_from_dict(rec.ALSAlgorithmParams, algo_params), train_launches,
            row_rel_limit=1e-4, label="ML-100K from sql", synthetic=False, timed=False)
    q_ms = np.asarray([dt_s for *_, dt_s in outs]) * 1e3
    result = {
        "host_numbers": True, "backend_numbers_are_the_mocks_for_es": True, **steps,
        "import_events_per_s": n_ratings / steps["import_s"],
        "partitioned_read_s": partitioned_read_s, "scan_partitions": 4,
        "train_spd_cg_launches": train_launches,
        "query_p50_ms": float(np.percentile(q_ms, 50)), "query_p99_ms": float(np.percentile(q_ms, 99)),
        "qps": len(outs) / query_wall, "queries": len(outs), "queries_all_200": True,
        "chunked_then_get": [c[0] for c in chunked],
        "phase_s": time.perf_counter() - t_phase,
    }
    emit(phase="sql_es_cli", shape=[n_users, n_items, n_ratings], **result)
    return {"launches": {"sql_es_cli": train_launches}, "rows": rows}


@phase
def jsonl_cli_phase(torch, home: str, device: str = "cuda", n_ratings: int = 100_000,
                    n_queries: int = 200) -> dict:
    """The recommendation template on a ``jsonl`` event store, every verb a
    process of the port's CLI (EVENTDATA jsonl, METADATA and MODELDATA one
    sqlite file): app new, import of 100,000 ML-100K-shape rate events (943
    users x 1,682 items, seed 13), one more rate event of a new user
    appended without its newline (a writer still appending), train (rank
    10, 10 iterations: 20 B1 launches; its columnar read through the host
    library's scan and its group-by through the host library, each counted
    in the train process), deploy, 200 queries. In this process the
    train's read (the DataSource's filters) through the host library
    equals the python encoder's on the same file, and neither holds the
    partial line; the trained model knows no user of it; every answer is
    200 and serve_batch's of the model read back from MODELDATA."""
    from predictionio_tpu_torch.data.storage import base
    from predictionio_tpu_torch.data.storage.registry import Storage
    from predictionio_tpu_torch.utils import native
    from predictionio_tpu_torch.workflow import model_io
    from predictionio_tpu_torch.workflow.engine_loader import load_engine

    t_phase = time.perf_counter()
    n_users, n_items = 943, 1682
    users, items, vals = synthesize_ratings(n_users, n_items, n_ratings, seed=13)
    work = work_dir(prefix="pio_smoke_jsonl_")
    root = os.path.dirname(os.path.abspath(__file__))
    env = {
        **os.environ, "PYTHONPATH": root,
        "PIO_STORAGE_SOURCES_S_TYPE": "sqlite", "PIO_STORAGE_SOURCES_S_PATH": os.path.join(work, "pio.db"),
        "PIO_STORAGE_SOURCES_J_TYPE": "jsonl", "PIO_STORAGE_SOURCES_J_PATH": os.path.join(work, "events"),
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "S", "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "S",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "J",
    }
    reports: list = []

    def run(*args) -> tuple[float, dict]:
        reports.append(os.path.join(work, f"report_{len(reports)}.json"))
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", _CLI_LAUNCHER, reports[-1], "--home", home, *args],
                              env=env, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"cli {args[0]} on jsonl failed ({proc.returncode}):\n{proc.stderr}")
        with open(reports[-1]) as fh:
            return time.perf_counter() - t0, json.load(fh)

    steps: dict = {}
    events = os.path.join(work, "events.jsonl")
    with open(events, "w") as fh:
        for k in range(n_ratings):
            fh.write(json.dumps({
                "event": "rate", "entityType": "user", "entityId": f"u{users[k]}",
                "targetEntityType": "item", "targetEntityId": f"i{items[k]}",
                "properties": {"rating": float(vals[k])},
                "eventTime": f"2024-05-{1 + k // 86_400:02d}T{k // 3600 % 24:02d}:{k // 60 % 60:02d}:"
                             f"{k % 60:02d}.000Z",
            }) + "\n")
    steps["app_new_s"], _ = run("app", "new", "jsonlapp")
    steps["import_s"], _ = run("import", "--appname", "jsonlapp", "--input", events)
    storage = Storage(env={**env, "PIO_FS_BASEDIR": home})
    app_id = storage.get_meta_data_apps().get_by_name("jsonlapp").id
    p_events = storage.get_p_events()
    with open(p_events._files.path(app_id, None), "a") as fh:  # a writer still appending
        fh.write(json.dumps({"event": "rate", "entityType": "user", "entityId": "u-partial",
                             "targetEntityType": "item", "targetEntityId": "i1",
                             "properties": {"rating": 5.0}, "eventId": "partial",
                             "eventTime": "2024-06-01T00:00:00.000Z"}))
    engine_dir = os.path.join(work, "engine")
    os.makedirs(engine_dir)
    with open(os.path.join(root, "predictionio_tpu_torch/models/recommendation/engine.json")) as fh:
        variant = json.load(fh)
    variant["id"] = "smoke-jsonl"
    variant["datasource"]["params"]["appName"] = "jsonlapp"
    with open(os.path.join(engine_dir, "engine.json"), "w") as fh:
        json.dump(variant, fh)
    steps["train_s"], train = run("train", "--engine-dir", engine_dir, "--device", device)
    train_launches = train["launches"].get("spd_cg", 0)
    if device == "cuda" and train_launches != 2 * variant["algorithms"][0]["params"]["numIterations"]:
        raise AssertionError(f"pio train on jsonl launched B1 {train_launches} times")
    if train["native_calls"].get("scan_jsonl_columnar", 0) < 1 or train["native_calls"].get("coo_group", 0) < 1:
        raise AssertionError(f"pio train on jsonl did not read or group through the host library: "
                             f"{train['native_calls']}")
    # the train's read, through the host library and through the python encoder
    read = dict(event_names=["rate", "buy"], entity_type="user", target_entity_type="item",
                rating_key="rating")
    t0 = time.perf_counter()
    cols = p_events.to_columnar(app_id, **read)
    steps["native_read_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    python = base.PEvents.to_columnar(p_events, app_id, **read)
    steps["python_read_s"] = time.perf_counter() - t0
    for name in ("event_ids", "event_names", "entity_vocab", "target_vocab", "event_vocab"):
        if list(getattr(cols, name)) != list(getattr(python, name)):
            raise AssertionError(f"jsonl_cli: the host library's {name} differs from the python encoder's")
    for name in ("entity_ids", "target_ids", "event_codes", "timestamps", "ratings"):
        a, b = getattr(cols, name), getattr(python, name)
        if a.dtype != b.dtype or not np.array_equal(a, b, equal_nan=name == "ratings"):
            raise AssertionError(f"jsonl_cli: the host library's {name} differs from the python encoder's")
    if len(cols) != n_ratings or "u-partial" in cols.entity_vocab:
        raise AssertionError(f"jsonl_cli: {len(cols)} rows read, partial user read: "
                             f"{'u-partial' in cols.entity_vocab}")
    manifest, _ = load_engine(engine_dir)
    instance = storage.get_meta_data_engine_instances().get_latest_completed(
        manifest.engine_id, manifest.version, manifest.variant)
    (model,) = model_io.deserialize_models(storage.get_model_data_models().get(instance.id).models)
    model.device = device
    if model.user_index("u-partial") is not None or len(model.user_vocab) != len(np.unique(users)):
        raise AssertionError("jsonl_cli: the trained model holds the partial line's user")
    cli, _, _ = _cli(home)
    server, base_url, steps["deploy_ready_s"] = _start_deploy(cli, env, engine_dir, work, device)
    try:
        port = int(base_url.rsplit(":", 1)[1])
        queried = [f"u{u}" for u in np.unique(users)[:n_queries].tolist()]
        outs, query_wall = _fleet_query_run(port, queried, clients=8)
    finally:
        _stop(server)
    if server.returncode != 0:
        raise AssertionError(f"deploy on jsonl exited {server.returncode} on SIGTERM")
    for path in reports:
        with open(path) as fh:
            foreign = json.load(fh)["foreign_modules"]
        if foreign:
            raise AssertionError(f"jsonl_cli {os.path.basename(path)}: imported {foreign[:5]}")
    remove_work(work)
    _fleet_answers_held(model, outs, "jsonl_cli")
    q_ms = np.asarray([dt_s for *_, dt_s in outs]) * 1e3
    result = {"host_numbers": True, **steps, "train_spd_cg_launches": train_launches,
              "train_native_calls": train["native_calls"], "rows_read": len(cols),
              "partial_line_read": False, "query_p50_ms": float(np.percentile(q_ms, 50)),
              "qps": len(outs) / query_wall, "queries": len(outs), "queries_all_200": True,
              "phase_s": time.perf_counter() - t_phase}
    emit(phase="jsonl_cli", shape=[n_users, n_items, n_ratings], **result)
    return {"launches": {"jsonl_cli": train_launches}}


REC_VARIANTS = ("blacklist-items", "customize-data-prep", "customize-serving", "reading-custom-events",
                "train-with-view-event")


def _variant_events(n_users: int, n_items: int, n_events: int, seed: int) -> list:
    """The recommendation variants' events (ML-100K shape): rate and buy,
    like where the synthetic rating is 3.5 or more and dislike below, and
    view; one second apart."""
    from predictionio_tpu_torch.data.event import Event

    users, items, vals = synthesize_ratings(n_users, n_items, n_events, seed=seed)
    t0 = 1_700_000_000
    out = []
    for k, (u, i, r) in enumerate(zip(users.tolist(), items.tolist(), vals.tolist())):
        kind = k % 8
        if kind < 3:
            name, props = "rate", {"rating": r}
        elif kind == 3:
            name, props = "buy", {}
        elif kind < 6:
            name, props = ("like" if r >= 3.5 else "dislike"), {}
        else:
            name, props = "view", {}
        out.append(Event(event=name, entity_type="user", entity_id=f"u{u}", target_entity_type="item",
                         target_entity_id=f"i{i}", properties=props, event_id=f"e{k}",
                         event_time=datetime.datetime.fromtimestamp(t0 + k, datetime.timezone.utc)))
    return out


def _variant_answers_held(model, queries, results, excluded, what: str, filtered=frozenset()) -> None:
    """Each answer the top of the user's float64 scores over the items it
    may serve: no excluded item (a blacklist, before the top-k) and no
    filtered one (disabled items, taken out of the top-k by the serving),
    every score within 1e-4 of the product's largest magnitude, and no
    item left out that scores higher (ties to that tolerance may trade)."""
    uf = np.asarray(model.user_factors, np.float64)
    vf = np.asarray(model.item_factors, np.float64)
    for q, res, banned in zip(queries, results, excluded):
        scores = uf[model.user_index(q.user)] @ vf.T
        tol = 1e-4 * float(np.abs(scores).max())
        ids = [model.item_index(s.item) for s in res.item_scores]
        got = np.asarray([s.score for s in res.item_scores])
        allowed = np.ones(len(vf), bool)
        allowed[[model.item_index(b) for b in banned | filtered if model.item_index(b) is not None]] = False
        want = min(q.num, int(allowed.sum()))
        if not want - len(filtered) <= len(ids) <= want or not allowed[ids].all():
            raise AssertionError(f"{what}: {q.user} served {ids}, excluded {sorted(banned)[:8]}")
        if not np.all(np.abs(got - scores[ids]) <= tol) or np.any(np.diff(got) > tol):
            raise AssertionError(f"{what}: {q.user}'s scores {got} against the float64 product {scores[ids]}")
        allowed[ids] = False
        if allowed.any() and scores[allowed].max() > got[-1] + tol:
            raise AssertionError(f"{what}: {q.user} left out a higher score {scores[allowed].max()} > {got[-1]}")


@phase
def rec_variants_phase(torch, home: str, n_users: int = 943, n_items: int = 1682, n_events: int = 100_000,
                       n_queries: int = 64) -> dict:
    """The recommendation template's five variants
    (predictionio_tpu_torch/models/recommendation/variants/), in-process on
    the card from one jsonl event store of the ML-100K shape (100,000
    events: rate, buy, like, dislike, view; seed 17) at rank 10, 10
    iterations: each trains with 20 B1 launches and answers 64 queries
    through its algorithm and serving, each answer the top of its user's
    float64 scores over what the variant may serve. blacklist-items: no
    blacklisted item served; customize-data-prep: the listed items absent
    from the factors' vocabulary; customize-serving: the disabled-items
    file edited live to list items just served, which the next answers
    leave out; reading-custom-events:
    like and dislike trained as ratings 4 and 1; train-with-view-event:
    implicit."""
    from predictionio_tpu_torch.data.storage.base import App
    from predictionio_tpu_torch.data.storage.registry import Storage
    from predictionio_tpu_torch.models.recommendation import engine as rec
    from predictionio_tpu_torch.ops.spd_solve import batched_spd_solve_fused
    from predictionio_tpu_torch.workflow.context import WorkflowContext
    from predictionio_tpu_torch.workflow.engine_loader import load_engine_factory

    t_phase = time.perf_counter()
    work = work_dir(prefix="pio_smoke_variants_")
    root = os.path.dirname(os.path.abspath(__file__))
    storage = Storage(env={"PIO_FS_BASEDIR": home,
                           "PIO_STORAGE_SOURCES_M_TYPE": "memory",
                           "PIO_STORAGE_SOURCES_J_TYPE": "jsonl",
                           "PIO_STORAGE_SOURCES_J_PATH": os.path.join(work, "events"),
                           "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "M",
                           "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "M",
                           "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "J"})
    app_id = storage.get_meta_data_apps().insert(App(0, "variantsapp"))
    storage.get_l_events().insert_batch(_variant_events(n_users, n_items, n_events, seed=17), app_id)
    files = {"preparator": os.path.join(work, "no_train_items.txt"),
             "serving": os.path.join(work, "disabled_items.txt")}
    with open(files["preparator"], "w") as fh:
        fh.write("i0\ni1\ni2\n")
    with open(files["serving"], "w") as fh:
        fh.write("i3\ni4\ni5\n")
    ctx = WorkflowContext(device="cuda", _storage=storage, app_name="variantsapp")
    rng = np.random.default_rng(19)
    out, launches = {}, {}
    try:
        for name in REC_VARIANTS:
            with open(os.path.join(root, "predictionio_tpu_torch/models/recommendation/variants",
                                   f"{name}.json")) as fh:
                variant = json.load(fh)
            variant["datasource"]["params"]["appName"] = "variantsapp"
            for part in ("preparator", "serving"):
                if part in variant:
                    variant[part]["params"]["filepath"] = files[part]
            engine = load_engine_factory(variant["engineFactory"])
            ep = engine.engine_params_from_variant(variant)
            data_source, _, (algo,), serving = engine.make_components(ep)
            batched_spd_solve_fused.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (model,) = engine.prepare_deploy(ctx, ep, engine.train(ctx, ep))
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            launches[name] = batched_spd_solve_fused.launches
            if launches[name] != 2 * variant["algorithms"][0]["params"]["numIterations"]:
                raise AssertionError(f"variant {name}: B1 launched {launches[name]} times")
            users = [model.user_vocab[u] for u in rng.choice(len(model.user_vocab), n_queries, replace=False)]
            banned = [frozenset(f"i{j}" for j in rng.choice(n_items, 40, replace=False))
                      if name == "blacklist-items" else frozenset() for _ in users]
            queries = [rec.Query(user=u, num=10, black_list=b or None) for u, b in zip(users, banned)]

            def answer(disabled=frozenset()):
                t0 = time.perf_counter()
                results = [serving.serve(q, [r]) for q, r in zip(queries, algo.predict_batch(model, queries))]
                _variant_answers_held(model, queries, results, banned, f"variant {name}", disabled)
                return results, (time.perf_counter() - t0) * 1e3

            checks: dict = {}
            if name == "customize-serving":
                results, answer_ms = answer(frozenset({"i3", "i4", "i5"}))
                # edited live to disable items just served: the next answers
                # leave them out, and may serve i3-i5 again
                edit = sorted({r.item_scores[0].item for r in results})[:5]
                with open(files["serving"], "w") as fh:
                    fh.write("".join(f"{item}\n" for item in edit))
                results, _ = answer(frozenset(edit))
                checks["disabled_by_the_edit"] = edit
            else:
                results, answer_ms = answer()
            if name == "customize-data-prep":
                if {"i0", "i1", "i2"} & set(model.item_vocab):
                    raise AssertionError("customize-data-prep: a listed item has factors")
                checks["items"] = len(model.item_vocab)
            elif name == "reading-custom-events":
                td = data_source.read_training(ctx)
                checks["ratings"] = sorted(set(np.unique(td.ratings).tolist()))
                if checks["ratings"] != [1.0, 4.0]:
                    raise AssertionError(f"reading-custom-events trained ratings {checks['ratings']}")
            elif name == "train-with-view-event" and not algo.params.implicit_prefs:
                raise AssertionError("train-with-view-event did not train implicitly")
            out[name] = {"train_s": train_s, "spd_cg_launches": launches[name], "queries": len(queries),
                         "answer_batch_ms": answer_ms, **checks}
    finally:
        remove_work(work)
    emit(phase="rec_variants", shape=[n_users, n_items, n_events], rank=10,
         phase_s=time.perf_counter() - t_phase, **out)
    return {"launches": {f"variant_{name}": n for name, n in launches.items()}}


@phase
def inprocess_serve_phase(torch, model) -> None:
    """The ML-20M model through ServingIndex.serve_batch against a plain
    torch.topk over U[u] @ V^T."""
    index = model.serving_index()
    rng = np.random.default_rng(5)
    batch, k = 256, 10
    uidx = rng.integers(0, index.n_users, batch).astype(np.int32)
    scores, idx = index.serve_batch(uidx, k)
    U, V = index.user_factors, index.item_factors
    ref_s, _ = torch.topk(U[torch.from_numpy(uidx).long().cuda()] @ V.T, k, dim=1)
    ref_s = ref_s.cpu().numpy()
    np.testing.assert_allclose(scores, ref_s, rtol=1e-5, atol=0)
    full = (U[torch.from_numpy(uidx).long().cuda()] @ V.T).cpu().numpy()
    for row in range(batch):  # every served id scores what it was served with
        np.testing.assert_allclose(full[row, idx[row]], scores[row], rtol=1e-5, atol=1e-6)
    lat = []
    for b in range(50):
        t0 = time.perf_counter()
        index.serve_batch(uidx[: 1 + b % 64], k)
        lat.append((time.perf_counter() - t0) * 1e3)
    emit(phase="serve_inprocess", n_users=index.n_users, n_items=index.n_items,
         batch=batch, k=k, serve_batch_p50_ms=float(np.percentile(lat, 50)))


# ---------------------------------------------------------------------------
# The sequential template: attention scorer, kernels B2 and B3
# ---------------------------------------------------------------------------

ATTENTION_SOURCES = {
    "attention_block": ("predictionio_tpu_torch/ops/csrc/attention_block.cu",
                        "predictionio_tpu/ops/attention.py:389"),
    "flash_attention": ("predictionio_tpu_torch/ops/csrc/flash_attention.cu",
                        "predictionio_tpu/ops/attention.py:285"),
}


def session_lengths(n_users: int, n_events: int, rng, n_long: int, max_len: int) -> np.ndarray:
    """Per-user session lengths of at least 20 that sum to ``n_events``:
    log-normal like the MovieLens releases, with ``n_long`` users past
    2,048 events so that a long window is full."""
    lengths = np.clip(np.round(rng.lognormal(4.55, 0.95, n_users)), 20, max_len).astype(np.int64)
    long_users = rng.choice(n_users, n_long, replace=False)
    lengths[long_users] = rng.integers(2049, max_len + 1, n_long)
    rest = np.setdiff1d(np.arange(n_users), long_users)
    target = n_events - int(lengths[long_users].sum())
    scaled = np.floor(lengths[rest] * target / lengths[rest].sum())
    scaled = np.clip(scaled, 20, max_len).astype(np.int64)
    order = rng.permutation(len(rest))
    while (diff := target - int(scaled.sum())) != 0:  # move the remainder one event at a time
        step = 1 if diff > 0 else -1
        room = order[(scaled[order] < max_len) if step > 0 else (scaled[order] > 20)]
        scaled[room[: abs(diff)]] += step
    lengths[rest] = scaled
    return lengths


def hop_sessions(lengths: np.ndarray, n_items: int, rng) -> list[np.ndarray]:
    """The bench's hop generator (bench.py:2731-2740), vectorised: a session
    starts at a random item; each next item is the last + 1..3 with
    probability 0.7, else a random item."""
    n = int(lengths.sum())
    jump = rng.random(n) >= 0.7
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    jump[starts] = True
    hop = np.where(jump, 0, rng.integers(1, 4, n))
    seg_start = np.flatnonzero(jump)
    seg = np.cumsum(jump) - 1
    walked = np.cumsum(hop)
    items = (rng.integers(0, n_items, n)[seg_start][seg] + walked - walked[seg_start][seg]) % n_items
    return np.split(items.astype(np.int32), starts[1:])


def attention_bound_ms(q, k, v, causal: bool):
    """Least time for the attention function on these tensors: each distinct
    input buffer read once and o written once, against the tensor work (4·D
    per visible query-key pair, bf16 rate) and the exponentials (one per
    visible pair, special-function rate). The scorer passes one tensor as q,
    k and v, which is then read once. The visible pairs are counted for
    these lengths: all of them, or under the causal mask sum_i min(i + 1, Lk).
    Returns the bound, what binds it ("bytes" or "operations") and each
    term."""
    from predictionio_tpu_torch.obs import costmodel

    B, H, Lq, D = q.shape
    inputs = {t.data_ptr(): t.numel() * t.element_size() for t in (q, k, v)}
    cost = costmodel.attention_cost(B, H, Lq, k.shape[2], D, causal, elem_bytes=q.element_size(),
                                    arg_bytes=sum(inputs.values()))
    ms, bound_by, terms = costmodel.bound_ms(cost)
    return ms, bound_by, {"bytes": terms["bytes"], "tensor_operations": terms["operations"],
                          "exponentials": terms["exponentials"]}


def attention_kernels(A) -> dict:
    """Kernel name -> (CUDA wrapper, plain version) of ops/attention.py."""
    return {"attention_block": (A.fused_attention_block, A._fused_attention_plain),
            "flash_attention": (A.flash_attention, A._flash_attention_plain)}


# B2 and B3 against their plain versions: one bf16 contract, f32 sums in
# another order, and every score whose tensor-core sum could move a row's
# max or flip bf16(p) summed again in the plain version's order (at most
# 2e-6 apart in earlier runs); a kernel that kept p in f32 before P·V would
# be 5e-4 or more off (tests/test_torch_attention.py)
ATTENTION_ATOL = 1e-5


@phase
def attention_kernel_phase(torch) -> None:
    """B2 and B3 against their plain versions and the f32 reference, causal
    and not. Limits: ATTENTION_ATOL against the plain version, 2e-2 against
    the reference (the bf16 bound of tests/test_attention.py:74)."""
    from predictionio_tpu_torch.ops import attention as A

    # (kernel, q shape [B, H, Lq, D], Lk)
    cases = [("attention_block", (64, 1, L, 32), L) for L in (8, 200, 1023)]
    cases += [("attention_block", (64, 1, 200, D), 200) for D in (10, 64)]
    cases += [("attention_block", (64, 2, 200, 32), 200)]
    # B2 keeps no score rows: a small tile with a long key axis, and Lq != Lk.
    # Lq = 3, not 1: at one query row torch's f32 product takes a matrix-vector
    # path that sums in another order than the plain version's column order
    cases += [("attention_block", (64, 1, 3, 32), 10_000), ("attention_block", (64, 1, 200, 32), 75)]
    cases += [("flash_attention", (64, 1, L, 32), L) for L in (1024, 2048, 1500)]
    cases += [("flash_attention", (16, 1, 700, 32), 2100), ("flash_attention", (16, 1, 2100, 32), 700)]
    # heads past 128 columns: the kernels' sliced variants
    cases += [(name, shape, shape[2]) for name in ("attention_block", "flash_attention")
              for shape in ((16, 2, 200, 160), (8, 1, 300, 256))]
    kernels = attention_kernels(A)
    for name, shape, Lk in cases:
        rng = np.random.default_rng(sum(shape) + Lk)
        q = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).cuda()
        k, v = (torch.from_numpy(rng.normal(size=(*shape[:2], Lk, shape[3])).astype(np.float32)).cuda()
                for _ in range(2))
        wrapper, plain = kernels[name]
        for causal in (False, True):
            out = wrapper(q, k, v, causal)
            torch.cuda.synchronize()
            err = float((out - plain(q, k, v, causal)).abs().max())
            ref_err = float((out - A.attention_reference(q, k, v, causal=causal)).abs().max())
            if not (torch.isfinite(out).all() and err <= ATTENTION_ATOL and ref_err <= 2e-2):
                raise AssertionError(
                    f"{name} {shape} causal={causal}: max abs err {err} (plain, limit "
                    f"{ATTENTION_ATOL}), {ref_err} (reference, limit 2e-2)"
                )
            emit(phase="kernel_attention", kernel=name, shape=list(shape), Lk=Lk, causal=causal,
                 max_abs_err=err, max_abs_err_reference=ref_err, atol=ATTENTION_ATOL,
                 atol_reference=2e-2)
    # 70,000 batch·heads, past the 65,535 blocks of a 1-D grid that B2 once
    # refused: over 1.1 M rows the bf16 contract's own distance from the f32
    # reference passes 2e-2 in its tail, so the kernel is held to the plain
    # version and to the plain version's distance from the reference
    rng = np.random.default_rng(70)
    q, k, v = (torch.from_numpy(rng.normal(size=(35_000, 2, 16, 32)).astype(np.float32)).cuda()
               for _ in range(3))
    for causal in (False, True):
        out = A.fused_attention_block(q, k, v, causal)
        plain = A._fused_attention_plain(q, k, v, causal)
        ref = A.attention_reference(q, k, v, causal=causal)
        err = float((out - plain).abs().max())
        gap = float((out - ref).abs().max()) - float((plain - ref).abs().max())
        if not (torch.isfinite(out).all() and err <= ATTENTION_ATOL and abs(gap) <= ATTENTION_ATOL):
            raise AssertionError(f"B2 at 70,000 batch·heads causal={causal}: {err} from the "
                                 f"plain version, {gap} further from the reference")
        emit(phase="kernel_attention", kernel="attention_block", shape=[35_000, 2, 16, 32],
             Lk=16, causal=causal, max_abs_err=err, reference_gap=gap, atol=ATTENTION_ATOL)


@phase
def wide_head_times(torch) -> list[dict]:
    """B2 and B3 past head dim 128 (the sliced variants) at the sequential
    scorer's serving shapes for ranks 160 and 256, causal: against the
    plain version (ATTENTION_ATOL times the output's scale, see b2_times),
    timed eager and as a CUDA graph beside the bound and SDPA."""
    from predictionio_tpu_torch.ops import attention as A
    from predictionio_tpu_torch.utils.cuda_timing import event_ms, graph_ms

    kernels = attention_kernels(A)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []
    for name, L in (("attention_block", 200), ("flash_attention", 1024)):
        wrapper, plain = kernels[name]
        for D in (160, 256):
            rng = np.random.default_rng(D + L)
            q, k, v = (torch.from_numpy(rng.normal(size=(64, 1, L, D)).astype(np.float32)).cuda()
                       for _ in range(3))
            want = plain(q, k, v, True)
            err = float((wrapper(q, k, v, True) - want).abs().max())
            scale = max(1.0, float(want.abs().max()))
            if not err <= ATTENTION_ATOL * scale:
                raise AssertionError(f"{name} at D={D}: {err} from the plain version")
            qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
            bound_ms, bound_by, bounds = attention_bound_ms(q, k, v, True)
            row = {"kernel": name, "shape": list(q.shape), "max_abs_err": err, "output_scale": scale,
                   "ms": event_ms(lambda: wrapper(q, k, v, True), reps=20),
                   "graph_ms": graph_ms(lambda: wrapper(q, k, v, True), launches=10),
                   "plain_ms": event_ms(lambda: plain(q, k, v, True), reps=1, warmup=0),
                   "library_ms": event_ms(lambda: sdpa(qb, kb, vb, is_causal=True), reps=20),
                   "library_graph_ms": graph_ms(lambda: sdpa(qb, kb, vb, is_causal=True), launches=10),
                   "bound_ms": bound_ms, "bound_by": bound_by, "bounds_ms": bounds}
            emit(phase="kernel_attention_wide", causal=True, **row)
            rows.append(row)
    return rows


@phase
def sequential_train_phase(torch, home: str):
    """AttentionAlgorithm.train on ML-1M-shaped sessions, held-out last item
    per user; hit-rate@10 of both scorers on the same held-out items."""
    from predictionio_tpu_torch.models.sequential import engine as seq
    from predictionio_tpu_torch.ops.spd_solve import batched_spd_solve_fused
    from predictionio_tpu_torch.workflow.context import WorkflowContext

    n_users, n_items, n_events, rank, iterations = 6040, 3706, 1_000_209, 32, 10
    t0 = time.perf_counter()
    rng = np.random.default_rng(12)
    sessions = hop_sessions(session_lengths(n_users, n_events, rng, 12, 2314), n_items, rng)
    vocab = [f"i{j}" for j in range(n_items)]
    users = [f"u{k}" for k in range(n_users)]
    td = seq.TrainingData(users, [s[:-1] for s in sessions], vocab)
    data_s = time.perf_counter() - t0
    algo = seq.AttentionAlgorithm(
        seq.AttentionAlgorithmParams(rank=rank, num_iterations=iterations, context=8))
    algo.timings = {}
    ctx = WorkflowContext(device="cuda", _storage=smoke_storage(home))
    torch.cuda.reset_peak_memory_stats()
    batched_spd_solve_fused.launches = 0
    t0 = time.perf_counter()
    model = algo.train(ctx, td)
    train_wall_s = time.perf_counter() - t0
    launches = batched_spd_solve_fused.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    def hit_rate(predict, queries):
        hits = 0
        for b in range(0, n_users, 64):
            for r, s in zip(predict(queries[b : b + 64]), sessions[b : b + 64]):
                hits += vocab[s[-1]] in {x.item for x in r.item_scores}
        return hits / n_users

    markov = seq.MarkovAlgorithm(seq.MarkovAlgorithmParams())
    rates = {}
    # bare-user queries: the template answers from the stored last item of
    # the training prefix; 8-item sessions: the window of the default context
    for protocol, queries in (
        ("last_item", [seq.Query(user=u, num=10) for u in users]),
        ("session_8", [seq.Query(recent_items=tuple(vocab[i] for i in s[-9:-1]), num=10)
                       for s in sessions]),
    ):
        rates[protocol] = {
            "attention": hit_rate(lambda qs: algo.predict_batch(model, qs), queries),
            "markov": hit_rate(lambda qs: [markov.predict(model, q) for q in qs], queries),
        }
    emit(phase="sequential_train", shape=[n_users, n_items, n_events], rank=rank,
         iterations=iterations, data_s=data_s, train_wall_s=train_wall_s, timings=algo.timings,
         spd_cg_launches=launches, peak_mem_gb=peak_gb, hit_rate_at_10=rates)
    if launches != 2 * iterations:
        raise AssertionError(f"B1 launched {launches} times, expected {2 * iterations}")
    # the template's gate, on bare-user queries: the window is the stored
    # last item repeated, so it holds the trained tables to the Markov chain
    att, mk = rates["last_item"]["attention"], rates["last_item"]["markov"]
    if not att >= 0.5 * mk:
        raise AssertionError(f"attention hit-rate@10 {att} below half of Markov's {mk}")
    # 8-item sessions mix 8 embeddings through B2: a wrong gather, window or
    # kernel falls to chance (10 of n_items); both packages score these
    # below the bare-user rate (tests/test_torch_sequential.py)
    att8, chance = rates["session_8"]["attention"], 10 / n_items
    if not att8 >= 20 * chance:
        raise AssertionError(f"8-item session hit-rate@10 {att8} below 20x chance ({chance})")
    return model, sessions, launches


@phase
def sequential_serve_phase(torch, model, sessions) -> list[dict]:
    """The trained model served in batches of 64 at context 8, 200 and 1024
    through predict_batch_dispatch; then each kernel timed at its serving
    shape."""
    from predictionio_tpu_torch.models.sequential import engine as seq
    from predictionio_tpu_torch.ops import attention as A
    from predictionio_tpu_torch.utils.cuda_timing import event_ms, graph_ms

    vocab = model.item_vocab
    table_in, table_out = model.device_in(), model.device_out()
    kernels = attention_kernels(A)
    by_length = np.argsort([-len(s) for s in sessions], kind="stable")
    rng = np.random.default_rng(13)
    n_dispatch, batch = 12, 64
    launches: dict[str, dict[str, int]] = {"attention_block": {}, "flash_attention": {}}
    shapes: dict[int, object] = {}
    for context in (8, 200, 1024):
        algo = seq.AttentionAlgorithm(seq.AttentionAlgorithmParams(rank=32, context=context))
        # at the long window take the longest sessions, so that windows are full
        pool = by_length[:batch] if context == 1024 else rng.permutation(len(sessions))
        batches = []
        for d in range(n_dispatch):
            rows = [pool[(d * batch + r) % len(pool)] for r in range(batch)]
            batches.append([seq.Query(recent_items=tuple(vocab[i] for i in sessions[u][-context:]),
                                      num=10) for u in rows])
        A.fused_attention_block.launches = 0
        A.flash_attention.launches = 0
        lat, results = [], []
        for queries in batches:
            t0 = time.perf_counter()
            results.append(algo.predict_batch_dispatch(model, queries)())
            lat.append((time.perf_counter() - t0) * 1e3)
        counts = {"attention_block": A.fused_attention_block.launches,
                  "flash_attention": A.flash_attention.launches}
        stage = []  # the host part of a dispatch: sessions, window and mask
        for queries in batches:
            t0 = time.perf_counter()
            algo._stage_batch(model, queries)
            stage.append((time.perf_counter() - t0) * 1e3)
        want = "attention_block" if A.route(context, context) == "block" else "flash_attention"
        if counts[want] != n_dispatch or sum(counts.values()) != n_dispatch:
            raise AssertionError(f"context {context}: launches {counts}, expected "
                                 f"{n_dispatch} of {want} (one per dispatch)")
        launches[want][f"serve_context_{context}"] = counts[want]
        # served scores against torch.topk over the plain-version session vectors
        worst = 0.0
        for queries, served in zip(batches[:3], results[:3]):
            hist, mask, sessions_idx, _ = algo._stage_batch(model, queries)
            x = table_in[torch.from_numpy(hist.copy()).cuda()].unsqueeze(1)
            vec = kernels[want][1](x, x, x, True)[:, 0, -1, :]
            scores = torch.where(torch.from_numpy(mask.copy()).cuda(), vec @ table_out.T, float("-inf"))
            ref = torch.topk(scores, 16, dim=1).values.cpu().numpy()
            for r, (res, sess) in enumerate(zip(served, sessions_idx)):
                got = np.asarray([s.score for s in res.item_scores])
                if len(got) != 10 or list(got) != sorted(got, reverse=True):
                    raise AssertionError(f"context {context}: a malformed result {res}")
                if set(sess) & {model.item_index()[s.item] for s in res.item_scores}:
                    raise AssertionError(f"context {context}: a session item was served")
                rel = float(np.abs(got - ref[r, :10]).max() / np.abs(ref[r, :10]).max())
                worst = max(worst, rel)
                if not rel <= ATTENTION_ATOL:
                    raise AssertionError(f"context {context}: served scores {got} against "
                                         f"plain {ref[r, :10]} (limit {ATTENTION_ATOL} of max)")
        shapes[context] = x
        emit(phase="sequential_serve", context=context, batch=batch, dispatches=n_dispatch,
             launches=counts, dispatch_p50_ms=float(np.percentile(lat, 50)),
             stage_p50_ms=float(np.percentile(stage, 50)),
             dispatch_p99_ms=float(np.percentile(lat, 99)), max_rel_score_err=worst)

    entries = []
    for context, name in ((8, "attention_block"), (200, "attention_block"), (1024, "flash_attention")):
        x = shapes[context]
        wrapper, plain = kernels[name]
        err = float((wrapper(x, x, x, True) - plain(x, x, x, True)).abs().max())
        xb = x.to(torch.bfloat16)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        # ms: back-to-back eager calls, host enqueue cost included;
        # graph_ms: device time per launch from a replayed CUDA graph
        t = {
            "ms": event_ms(lambda: wrapper(x, x, x, True), reps=50),
            "graph_ms": graph_ms(lambda: wrapper(x, x, x, True)),
            "plain_ms": event_ms(lambda: plain(x, x, x, True), reps=5),
            "library_ms": event_ms(lambda: sdpa(xb, xb, xb, is_causal=True), reps=50),
            "library_graph_ms": graph_ms(lambda: sdpa(xb, xb, xb, is_causal=True)),
        }
        bound_ms, bound_by, bounds = attention_bound_ms(x, x, x, True)
        emit(phase="kernel_attention_real", kernel=name, shape=list(x.shape), causal=True,
             max_abs_err=err, bound_ms=bound_ms, bound_by=bound_by, bounds_ms=bounds, **t)
        if context == 8:
            continue  # the B2 entry of the kernels line is at SASRec's window
        source, replaces = ATTENTION_SOURCES[name]
        entries.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(launches[name].values()), "launches_by_path": launches[name],
            "max_abs_err": err, "ms": t["ms"], "graph_ms": t["graph_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": bound_ms, "bound_by": bound_by,
            "bounds_ms": bounds, "library_ms": t["library_ms"],
            "library_graph_ms": t["library_graph_ms"], "shape": list(x.shape),
        })
    return entries


def _write_sequential_events(path: str, n_users: int, n_items: int, n_events: int, seed: int):
    """ML-100K-shape view events, sessions interleaved across users, each
    line with a strictly increasing creationTime and an explicit eventId,
    so that the store's order is the session order."""
    import datetime as dt

    rng = np.random.default_rng(seed)
    lengths = session_lengths(n_users, n_events, rng, 0, 737)
    sessions = hop_sessions(lengths, n_items, rng)
    user_of = np.repeat(np.arange(n_users), lengths)
    items = np.concatenate(sessions)
    keys = rng.random(n_events)
    keys = keys[np.lexsort((keys, user_of))]  # ascending within each user's session
    order = np.argsort(keys, kind="stable")
    t0 = dt.datetime(2024, 1, 1, tzinfo=dt.timezone.utc)
    with open(path, "w") as fh:
        for n, e in enumerate(order):
            t = (t0 + dt.timedelta(milliseconds=n)).isoformat()
            fh.write(json.dumps({
                "event": "view", "entityType": "user", "entityId": f"u{user_of[e]}",
                "targetEntityType": "item", "targetEntityId": f"i{items[e]}",
                "eventTime": t, "creationTime": t, "eventId": f"e{n:07d}",
            }) + "\n")
    return sessions


@phase
def sequential_cli_phase(home: str, device: str = "cuda") -> dict:
    """app new -> import -> train -> deploy of the attention algorithm
    through the port's CLI, then POST /queries.json."""
    n_users, n_items, n_events = 943, 1682, 100_000
    work = work_dir(prefix="pio_smoke_seq_")
    events = os.path.join(work, "views.jsonl")
    sessions = _write_sequential_events(events, n_users, n_items, n_events, seed=14)
    engine_dir = os.path.join(work, "engine")
    os.makedirs(engine_dir)
    with open(os.path.join(engine_dir, "engine.json"), "w") as fh:
        json.dump({
            "id": "smoke-seq",
            "engineFactory": "predictionio_tpu_torch.models.sequential.engine.engine_factory",
            "datasource": {"params": {"appName": "seqapp"}},
            "algorithms": [{"name": "attention", "params": {
                "rank": 32, "numIterations": 10, "context": 8}}],
        }, fh)
    cli, env, run = _cli(home)

    steps = {
        "app_new_s": run("app", "new", "seqapp"),
        "import_s": run("import", "--appname", "seqapp", "--input", events),
        "train_s": run("train", "--engine-dir", engine_dir, "--device", device),
    }
    server, base, steps["deploy_ready_s"] = _start_deploy(cli, env, engine_dir, work, device)
    latencies = []
    try:
        for u in range(0, 40, 4):
            session = [f"i{i}" for i in sessions[u][-(3 + u % 9):]]
            status, body, dt = _http(base + "/queries.json", {"recentItems": session, "num": 10})
            if status != 200:
                raise AssertionError(f"recentItems query answered {status}")
            _check_result(body, 10, n_items, banned=set(session))
            latencies.append(dt)
        status, body, dt = _http(base + "/queries.json", {"user": "u5", "num": 6})
        # the stored last item of u5's session answers and is not served
        if status != 200:
            raise AssertionError(f"bare user query answered {status}")
        _check_result(body, 6, n_items, banned={f"i{sessions[5][-1]}"})
        latencies.append(dt)
        status, body, dt = _http(base + "/queries.json", {"user": "no-such-user", "num": 5})
        if status != 200 or body != {"itemScores": []}:
            raise AssertionError(f"unknown user answered {status} {body}")
        latencies.append(dt)
        largest = 0
        for burst in range(3):  # until the micro-batcher has batched a burst
            payloads = [{"recentItems": [f"i{i}" for i in sessions[u][-8:]], "num": 10}
                        for u in range(burst * 64, burst * 64 + 64)]
            with concurrent.futures.ThreadPoolExecutor(64) as pool:
                outs = list(pool.map(lambda p: _http(base + "/queries.json", p), payloads))
            for p, (status, body, dt) in zip(payloads, outs):
                if status != 200:
                    raise AssertionError(f"burst query answered {status}")
                _check_result(body, 10, n_items, banned=set(p["recentItems"]))
                latencies.append(dt)
            _, st, _ = _http(base + "/")
            largest = st["largestBatch"]
            if largest > 1:
                break
        if largest < 2:
            raise AssertionError("the micro-batcher never batched a concurrent burst")
        _stop(server)
        server = None
        captures = sequential_captures(cli, env, engine_dir, work, device, sessions)
    finally:
        if server is not None:
            _stop(server)
        remove_work(work)
    lat_ms = np.asarray(latencies) * 1e3
    result = {**steps, "requests": len(latencies), "all_200": True, "captures": captures,
              "p50_ms": float(np.percentile(lat_ms, 50)), "p99_ms": float(np.percentile(lat_ms, 99)),
              "largest_batch": largest, "batches": st["batches"], "queries": st["queries"]}
    emit(phase="sequential_cli", shape=[n_users, n_items, n_events], **result)
    return result


# ---------------------------------------------------------------------------
# The two-tower template: its history encoder through kernel B2, in training
# and in serving
# ---------------------------------------------------------------------------

# the JAX package's recall@10 on the bench's clustered data with a 32-item
# history encoder, trained on the CPU (the same data and config as
# twotower_quality_phase); the bench's own gate (> 0.4, bench.py:1299) is
# for the model without the encoder, which reaches 0.4745 there
JAX_CPU_RECALL_HISTORY_32 = 0.0545
BENCH_RECALL_GATE = 0.4


def encoder_qkv(torch, model, users: np.ndarray):
    """The q, k and v [B, 2, 256, 32] that the trained two-tower encoder
    hands to attention for these users' histories: the main path's own
    operands of B2."""
    from predictionio_tpu_torch.ops import attention as A

    hist = torch.from_numpy(model.history[users].astype(np.int64)).cuda()
    seen = []
    real = A._fused_attention_forward
    try:
        A._fused_attention_forward = lambda q, k, v, causal: seen.append((q, k, v)) or real(q, k, v, causal)
        with torch.no_grad():
            model.module().hist_encoder(hist)
    finally:
        A._fused_attention_forward = real
    return seen[0]


def b2_times(torch, q, k, v, label: str) -> dict:
    """B2 causal on the encoder's q, k, v against its plain version, timed
    eager (``ms``) and as a replayed CUDA graph (``graph_ms``) beside its
    bound and scaled_dot_product_attention on bf16 (eager and graph). The
    limit is ATTENTION_ATOL times the output's scale: the P·V sums are
    not settled, and their order's rounding grows with |o| (on unit-normal
    q = k = v at [4096, 2, 256, 32], where |o| reaches 4, the kernel came
    out just past 1e-5 from the plain version with the scores identical)."""
    from predictionio_tpu_torch.ops import attention as A
    from predictionio_tpu_torch.utils.cuda_timing import event_ms, graph_ms

    plain = A._fused_attention_plain(q, k, v, True)
    err = float((A.fused_attention_block(q, k, v, True) - plain).abs().max())
    scale = max(1.0, float(plain.abs().max()))
    if not err <= ATTENTION_ATOL * scale:
        raise AssertionError(f"B2 at {label} {tuple(q.shape)}: {err} from the plain version "
                             f"(limit {ATTENTION_ATOL} x {scale})")
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    big = q.shape[0] >= 1024
    t = {
        "ms": event_ms(lambda: A.fused_attention_block(q, k, v, True), reps=10 if big else 50),
        "graph_ms": graph_ms(lambda: A.fused_attention_block(q, k, v, True),
                             launches=5 if big else 20),
        "plain_ms": event_ms(lambda: A._fused_attention_plain(q, k, v, True), reps=3),
        "library_ms": event_ms(lambda: sdpa(qb, kb, vb, is_causal=True), reps=10 if big else 50),
        "library_graph_ms": graph_ms(lambda: sdpa(qb, kb, vb, is_causal=True),
                                     launches=5 if big else 20),
    }
    bound_ms, bound_by, bounds = attention_bound_ms(q, k, v, True)
    row = {"shape": list(q.shape), "at": label, "max_abs_err": err, "output_scale": scale,
           "bound_ms": bound_ms, "bound_by": bound_by, "bounds_ms": bounds, **t}
    emit(phase="kernel_attention_real", kernel="attention_block", causal=True, **row)
    return row


@phase
def twotower_train_phase(torch, home: str, n_users: int = 138_000, n_items: int = 27_000,
                         n_slice: int = 1_000_000, batch: int = 4096):
    """TwoTowerAlgorithm.train at full width (ML-20M vocabulary, 138,000
    users x 27,000 items, embed 64, hidden [128], out 32, 2 heads of 32,
    historyLen 256, batch 4096) for one epoch over a 1,000,000-rating slice
    of the ML-20M data with synthetic times: 244 steps, B2's launches read
    around it (one forward per step: 256² f32 scores are under 4 MiB). The
    loss of the untrained model on the epoch's first batch, then the
    epoch's: finite and falling."""
    from predictionio_tpu_torch.models.twotower import engine as tt
    from predictionio_tpu_torch.models.twotower import model as M
    from predictionio_tpu_torch.ops import attention as A
    from predictionio_tpu_torch.workflow.context import WorkflowContext

    t0 = time.perf_counter()
    users, items, _ = synthesize_ratings(n_users, n_items, 10 * n_slice)
    users, items = users[:n_slice], items[:n_slice]
    times = np.random.default_rng(21).random(n_slice) * 1e8
    td = tt.TrainingData(users, items, [f"u{i}" for i in range(n_users)],
                         [f"i{i}" for i in range(n_items)], times)
    data_s = time.perf_counter() - t0
    params = tt.TwoTowerAlgorithmParams(embed_dim=64, hidden=(128,), out_dim=32, n_heads=2,
                                        history_len=256, batch_size=batch, epochs=1)
    algo = tt.TwoTowerAlgorithm(params)
    steps = n_slice // params.batch_size
    # the untrained model's loss on the first batch of the epoch
    config = M.TwoTowerConfig(n_users=n_users, n_items=n_items, embed_dim=64, hidden=(128,),
                              out_dim=32, n_heads=2, history_len=256, batch_size=batch, epochs=1)
    hist = M.build_history_matrix(users, items, times, n_users, 256)
    first = np.random.default_rng(config.seed).permutation(n_slice)[: params.batch_size]
    net = M.build_model(config, "cuda")
    ub, ib, h = (torch.from_numpy(np.asarray(a, np.int64)).cuda()
                 for a in (users[first], items[first], hist[users[first]]))
    with torch.no_grad():
        h = torch.where(h == ib[:, None], -1, h)  # the step's target masking
        log_q = torch.from_numpy(M.item_log_q(items, n_items)).cuda()
        loss0 = float(M.loss_fn(net, ub, ib, config.temperature, h, log_q))
    del net
    torch.cuda.reset_peak_memory_stats()
    ctx = WorkflowContext(device="cuda", _storage=smoke_storage(home))
    A.fused_attention_block.launches = 0
    A.flash_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = algo.train(ctx, td)
    torch.cuda.synchronize()
    train_wall_s = time.perf_counter() - t0
    launches = A.fused_attention_block.launches
    flash = A.flash_attention.launches
    losses = [loss0, *model.losses]
    emit(phase="twotower_train", shape=[n_users, n_items, n_slice], history_len=256,
         batch=params.batch_size, steps=steps, data_s=data_s, train_wall_s=train_wall_s,
         steps_per_s=steps / train_wall_s, examples_per_s=steps * params.batch_size / train_wall_s,
         loss_untrained=loss0, loss_per_epoch=model.losses,
         attention_block_launches=launches, flash_attention_launches=flash,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    if launches != steps or flash != 0:
        raise AssertionError(f"two-tower train: B2 launched {launches} times and B3 {flash}, "
                             f"expected {steps} and 0 (one B2 forward per step)")
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"two-tower losses {losses}: not finite and falling")
    return model, algo, td, launches


@phase
def twotower_step_split(torch, td, batch: int = 4096) -> dict:
    """One full-width training step and its parts by CUDA events: B2's
    forward alone, the attention backward alone (the f32 reference's
    gradient as torch matrix products), Adam's update alone, and the rest
    (towers, encoder layers, loss, their backward) as the difference."""
    from predictionio_tpu_torch.models.twotower import model as M
    from predictionio_tpu_torch.ops import attention as A
    from predictionio_tpu_torch.utils.cuda_timing import event_ms

    n_users, n_items = len(td.user_vocab), len(td.item_vocab)
    config = M.TwoTowerConfig(n_users=n_users, n_items=n_items, embed_dim=64, hidden=(128,),
                              out_dim=32, n_heads=2, history_len=256, batch_size=batch)
    net = M.build_model(config, "cuda")
    opt = M.make_optimizer(net, config.learning_rate)
    log_q = torch.from_numpy(M.item_log_q(td.item_idx, n_items)).cuda()
    step = M.make_train_step(net, opt, config.temperature, True, log_q)
    hist = torch.from_numpy(M.build_history_matrix(
        td.user_idx, td.item_idx, td.timestamps, n_users, 256).astype(np.int64)).cuda()
    sel = np.random.default_rng(3).permutation(len(td.user_idx))[:batch]
    ub = torch.from_numpy(td.user_idx[sel].astype(np.int64)).cuda()
    ib = torch.from_numpy(td.item_idx[sel].astype(np.int64)).cuda()
    step_ms = event_ms(lambda: step(ub, ib, hist), reps=10, warmup=3)
    rng = np.random.default_rng(4)
    q, k, v, g = (torch.from_numpy(rng.normal(size=(batch, 2, 256, 32)).astype(np.float32)).cuda()
                  for _ in range(4))
    fwd_ms = event_ms(lambda: A.fused_attention_block(q, k, v, True), reps=10)
    bwd_ms = event_ms(lambda: A.attention_reference_grad(q, k, v, g, True), reps=5)
    adam_ms = event_ms(opt.step, reps=10)
    split = {"step_ms": step_ms, "b2_forward_ms": fwd_ms, "attention_backward_ms": bwd_ms,
             "adam_ms": adam_ms, "rest_ms": step_ms - fwd_ms - bwd_ms - adam_ms}
    emit(phase="twotower_step_split", **split)
    return split


@phase
def twotower_serve_phase(torch, model, algo) -> int:
    """The trained model through predict_batch_dispatch in batches of 64
    users with their 256-item histories: one B2 launch per dispatch. The
    encoder's output against its plain version (atol 1e-4: B2 within 1e-5
    of it, one f32 projection and a mean); served scores against a
    torch.topk over the plain version's user vectors (atol 1e-2: the bf16
    towers may round one input the other way on a 1e-6 difference), and
    every served id within that of the plain k-th score."""
    from predictionio_tpu_torch.models.twotower import engine as tt
    from predictionio_tpu_torch.ops import attention as A
    from predictionio_tpu_torch.workflow.context import WorkflowContext

    model = algo.prepare_model(WorkflowContext(device="cuda"), model)
    rng = np.random.default_rng(22)
    n_dispatch, batch, k = 12, 64, 10
    picks = [rng.integers(0, len(model.user_vocab), batch) for _ in range(n_dispatch)]
    batches = [[tt.Query(user=model.user_vocab[u], num=k) for u in rows] for rows in picks]
    algo.predict_batch_dispatch(model, batches[0])()  # first use outside the count
    A.fused_attention_block.launches = 0
    lat, served = [], []
    for queries in batches:
        t0 = time.perf_counter()
        served.append(algo.predict_batch_dispatch(model, queries)())
        lat.append((time.perf_counter() - t0) * 1e3)
    launches = A.fused_attention_block.launches
    if launches != n_dispatch:
        raise AssertionError(f"two-tower serve: B2 launched {launches} times for {n_dispatch} dispatches")
    net = model.module()
    item_index = {it: i for i, it in enumerate(model.item_vocab)}
    worst_enc = worst = 0.0
    for rows, results in zip(picks[:3], served[:3]):
        uidx = torch.from_numpy(rows.astype(np.int64)).cuda()
        hist = torch.from_numpy(model.history[rows].astype(np.int64)).cuda()
        real = A._fused_attention_forward
        with torch.no_grad():
            enc = net.hist_encoder(hist)
            try:
                A._fused_attention_forward = lambda q, k_, v, c: A._fused_attention_plain(q, k_, v, c)
                enc_plain = net.hist_encoder(hist)
                u = net.embed_users(uidx, hist)
            finally:
                A._fused_attention_forward = real
        worst_enc = max(worst_enc, float((enc - enc_plain).abs().max()))
        scores = (u @ model.device_items().T).cpu().numpy()
        top = np.sort(scores, axis=1)[:, ::-1][:, :k]
        for r, res in enumerate(results):
            got = np.asarray([s.score for s in res.item_scores])
            ids = [item_index[s.item] for s in res.item_scores]
            if len(got) != k or list(got) != sorted(got, reverse=True):
                raise AssertionError(f"two-tower serve: a malformed result {res}")
            worst = max(worst, float(np.abs(got - top[r]).max()))
            if not (np.abs(got - top[r]).max() <= 1e-2 and np.all(scores[r, ids] >= top[r, -1] - 1e-2)):
                raise AssertionError(f"two-tower serve: scores {got} against plain {top[r]}")
    if not worst_enc <= 1e-4:
        raise AssertionError(f"two-tower encoder: {worst_enc} from its plain version")
    emit(phase="twotower_serve", batch=batch, dispatches=n_dispatch, history_len=256,
         attention_block_launches=launches, dispatch_p50_ms=float(np.percentile(lat, 50)),
         dispatch_p99_ms=float(np.percentile(lat, 99)), max_encoder_err=worst_enc,
         max_score_err=worst)
    return launches


def clustered_recall_data(n_users=2000, n_items=1000, n_clusters=20, pos_per_user=30, seed=0):
    """The bench's clustered positives (bench.py:1506-1580): 90 % of a
    user's items in the user's cluster, one in-cluster item held out."""
    rng = np.random.default_rng(seed)
    user_cluster = rng.integers(0, n_clusters, n_users)
    item_cluster = rng.integers(0, n_clusters, n_items)
    items_by_cluster = [np.flatnonzero(item_cluster == c) for c in range(n_clusters)]
    all_items = np.arange(n_items)
    train_u, train_i, test_u, test_i = [], [], [], []
    for u in range(n_users):
        own = items_by_cluster[user_cluster[u]]
        if len(own) < 2:
            continue
        n_in = min(int(round(pos_per_user * 0.9)), len(own))
        in_cluster = rng.choice(own, n_in, replace=False)
        tail = rng.choice(all_items, pos_per_user - n_in, replace=False)
        pos = np.concatenate([in_cluster, tail[tail != in_cluster[0]]])
        train_u.extend([u] * (len(pos) - 1))
        train_i.extend(pos[1:])
        test_u.append(u)
        test_i.append(pos[0])
    return (np.asarray(train_u, np.int32), np.asarray(train_i, np.int32),
            np.asarray(test_u, np.int64), np.asarray(test_i, np.int64))


@phase
def twotower_quality_phase(torch, epochs: int = 16) -> dict:
    """recall@10 on the bench's clustered data (embed 32, hidden [64], out
    16, batch 1024, 16 epochs) with a 32-item history encoder, gated at the
    JAX package's CPU value less 0.05, and without the encoder, gated at the
    bench's 0.4; the held-out item ranked among the full catalogue with the
    user's other training items masked."""
    from predictionio_tpu_torch.models.twotower import model as M
    from predictionio_tpu_torch.ops import attention as A

    tu, ti, test_u, test_i = clustered_recall_data()
    out = {}
    for history_len, gate in ((32, JAX_CPU_RECALL_HISTORY_32 - 0.05), (0, BENCH_RECALL_GATE)):
        config = M.TwoTowerConfig(n_users=2000, n_items=1000, embed_dim=32, hidden=(64,),
                                  out_dim=16, batch_size=1024, epochs=epochs, seed=0,
                                  history_len=history_len)
        hist = M.build_history_matrix(tu, ti, None, 2000, history_len) if history_len else None
        A.fused_attention_block.launches = 0
        t0 = time.perf_counter()
        res = M.train_two_tower(tu, ti, config, history=hist, device="cuda")
        wall = time.perf_counter() - t0
        launches = A.fused_attention_block.launches
        net = M.TwoTower(config)
        net.load_state_dict({k: torch.from_numpy(v) for k, v in res.params.items()})
        net = net.cuda().eval()
        h = torch.from_numpy(hist[test_u].astype(np.int64)).cuda() if history_len else None
        u = M.user_embedding(net, torch.from_numpy(test_u).cuda(), h).cpu().numpy()
        scores = u @ res.item_embeddings.T
        for row, user in enumerate(test_u):
            seen = ti[(tu == user) & (ti != test_i[row])]
            scores[row, seen] = -np.inf
        top10 = np.argpartition(-scores, 10, axis=1)[:, :10]
        recall = float(np.mean([t in r for r, t in zip(top10, test_i)]))
        out[history_len] = {"recall_at_10": recall, "gate": gate, "train_wall_s": wall,
                            "losses": res.losses, "attention_block_launches": launches}
        emit(phase="twotower_quality", history_len=history_len, recall_at_10=recall, gate=gate,
             jax_cpu_recall=JAX_CPU_RECALL_HISTORY_32 if history_len else 0.4745,
             chance=10 / 1000, train_wall_s=wall, losses=res.losses,
             attention_block_launches=launches)
        steps = epochs * (len(tu) // 1024)
        if history_len and launches != steps:
            raise AssertionError(f"recall train: B2 launched {launches} times, expected {steps}")
        if not (recall > gate and np.all(np.isfinite(res.losses))):
            raise AssertionError(f"two-tower recall@10 {recall} at history {history_len}: gate {gate}")
    return out


@phase
def twotower_cli_phase(home: str, device: str = "cuda") -> dict:
    """app new -> import of an ML-100K-shape file (its users and items, half
    its ratings: 50,000) -> train with historyLen 50 (1 epoch) -> deploy,
    from an engine.json naming the JAX package's factory string, then POST
    /queries.json answered 200."""
    n_users, n_items, n_ratings = 943, 1682, 50_000
    users, items, vals = synthesize_ratings(n_users, n_items, n_ratings, seed=2)
    work = work_dir(prefix="pio_smoke_tt_")
    events = os.path.join(work, "events.jsonl")
    with open(events, "w") as fh:
        for k, (u, i, r) in enumerate(zip(users.tolist(), items.tolist(), vals.tolist())):
            fh.write(json.dumps({
                "event": "rate", "entityType": "user", "entityId": f"u{u}",
                "targetEntityType": "item", "targetEntityId": f"i{i}",
                "properties": {"rating": r},
                "eventTime": f"2024-01-01T{k // 360000 % 24:02d}:{k // 6000 % 60:02d}:"
                             f"{k // 100 % 60:02d}.{k % 100:03d}Z",
            }) + "\n")
    engine_dir = os.path.join(work, "engine")
    os.makedirs(engine_dir)
    with open(os.path.join(engine_dir, "engine.json"), "w") as fh:
        json.dump({
            "id": "smoke-twotower",
            "engineFactory": "predictionio_tpu.models.twotower.engine_factory",
            "datasource": {"params": {"appName": "ttapp"}},
            "algorithms": [{"name": "twotower", "params": {
                "embedDim": 64, "hidden": [128], "outDim": 32, "epochs": 1, "batchSize": 4096,
                "historyLen": 50, "nHeads": 2}}],
        }, fh)
    cli, env, run = _cli(home)
    steps = {
        "app_new_s": run("app", "new", "ttapp"),
        "import_s": run("import", "--appname", "ttapp", "--input", events),
        "train_s": run("train", "--engine-dir", engine_dir, "--device", device),
    }
    server, base, steps["deploy_ready_s"] = _start_deploy(cli, env, engine_dir, work, device)
    latencies = []
    try:
        for u in range(0, 40, 4):
            status, body, dt = _http(base + "/queries.json", {"user": f"u{u}", "num": 10})
            if status != 200:
                raise AssertionError(f"two-tower query answered {status}")
            _check_result(body, 10, n_items)
            latencies.append(dt)
        status, body, dt = _http(base + "/queries.json", {"user": "no-such-user", "num": 5})
        if status != 200 or body != {"itemScores": []}:
            raise AssertionError(f"unknown user answered {status} {body}")
        latencies.append(dt)
        with concurrent.futures.ThreadPoolExecutor(32) as pool:
            outs = list(pool.map(
                lambda u: _http(base + "/queries.json", {"user": f"u{u}", "num": 10}), range(64)))
        for status, body, dt in outs:
            if status != 200:
                raise AssertionError(f"burst query answered {status}")
            _check_result(body, 10, n_items)
            latencies.append(dt)
        _, st, _ = _http(base + "/")
    finally:
        _stop(server)
        remove_work(work)
    lat_ms = np.asarray(latencies) * 1e3
    result = {**steps, "requests": len(latencies), "all_200": True,
              "p50_ms": float(np.percentile(lat_ms, 50)), "p99_ms": float(np.percentile(lat_ms, 99)),
              "largest_batch": st["largestBatch"], "batches": st["batches"], "queries": st["queries"]}
    emit(phase="twotower_cli", shape=[n_users, n_items, n_ratings], history_len=50, **result)
    return result


# ---------------------------------------------------------------------------
# The rest of the template gallery: similar-product, e-commerce and
# recommended-user (implicit ALS through kernel B1), and classification
# ---------------------------------------------------------------------------

# The JAX package's quality values on the CPU, which set the gates below
# (less 0.05); tests/test_torch_similarproduct.py and
# tests/test_torch_recommendeduser.py recompute them through the JAX package
# and hold these constants to them. Similar-product: the share of each
# item's top-10 similar items in its own cluster, on the bench's clustered
# data. Recommended-user: the share of each user's top-10 similar users in
# its own community, on the small follow graph FOLLOW_GATE_GRAPH.
JAX_CPU_SIMILAR_CLUSTER_SHARE = 1.0
JAX_CPU_FOLLOW_COMMUNITY_SHARE = 1.0
FOLLOW_GATE_GRAPH = (5_000, 50, 100_000)  # users, communities, follows
GALLERY_ALS = {"rank": 10, "num_iterations": 10, "lambda_": 0.01, "alpha": 1.0, "seed": 3}


def clustered_item_groups(n_users=2000, n_items=1000, n_clusters=20, seed=0) -> np.ndarray:
    """The item clusters of ``clustered_recall_data`` (its second draw)."""
    rng = np.random.default_rng(seed)
    rng.integers(0, n_clusters, n_users)
    return rng.integers(0, n_clusters, n_items)


def follow_graph(n_users: int, n_communities: int, n_follows: int, seed: int = 0,
                 in_share: float = 0.9):
    """(follower, followed) pairs: user u belongs to community u mod
    ``n_communities``; a follow stays inside the follower's community with
    probability ``in_share``, else goes to any user; self-follows dropped."""
    rng = np.random.default_rng(seed)
    follower = rng.integers(0, n_users, n_follows)
    inside = rng.random(n_follows) < in_share
    same = follower % n_communities + n_communities * rng.integers(
        0, n_users // n_communities, n_follows)
    followed = np.where(inside, same, rng.integers(0, n_users, n_follows))
    keep = followed != follower
    return follower[keep].astype(np.int32), followed[keep].astype(np.int32)


def same_group_share(query_groups, answers) -> float:
    """Mean over queries of the share of the answered ids (integers) whose
    group is the query's; ``answers`` holds (ids, groups of the ids)."""
    shares = [float(np.mean(groups == g)) for g, (_, groups) in zip(query_groups, answers)
              if len(groups)]
    return float(np.mean(shares))


def similar_items_share(algo, model, query_cls, item_cluster: np.ndarray,
                        batch: int = 64) -> float:
    """Each item as a one-item query (top-10, in batches): the share of the
    answers in the query item's cluster."""
    n = len(item_cluster)
    answers = []
    for s in range(0, n, batch):
        res = algo.predict_batch(model, [query_cls(items=(f"i{i}",), num=10)
                                         for i in range(s, min(s + batch, n))])
        for r in res:
            ids = np.asarray([int(x.item[1:]) for x in r.item_scores], np.int64)
            answers.append((ids, item_cluster[ids]))
    return same_group_share(item_cluster, answers)


def similar_users_share(algo, model, query_cls, users: np.ndarray, n_communities: int,
                        batch: int = 64) -> float:
    """Each user as a one-user query (top-10, in batches): the share of the
    answers in the query user's community."""
    answers = []
    for s in range(0, len(users), batch):
        res = algo.predict_batch(model, [query_cls(users=(f"u{u}",), num=10)
                                         for u in users[s : s + batch]])
        for r in res:
            ids = np.asarray([int(x.user[1:]) for x in r.similar_user_scores], np.int64)
            answers.append((ids, ids % n_communities))
    return same_group_share(users % n_communities, answers)


def _counted_train(torch, algo, ctx, td):
    """algo.train with B1's launches counted around it and the wall time."""
    from predictionio_tpu_torch.ops.spd_solve import batched_spd_solve_fused

    algo.timings = {}
    batched_spd_solve_fused.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = algo.train(ctx, td)
    torch.cuda.synchronize()
    return model, time.perf_counter() - t0, batched_spd_solve_fused.launches


def _implicit_b1_rows(torch, users, items, counts, n_users, n_items, label: str) -> list[dict]:
    """B1 on a template train's own implicit systems (rank 10): the train
    is repeated outside the counted run to get its factors, then both
    sides' regularised normal equations are solved by B1 and its plain
    version and timed. The limit is the kernel phase's 1e-4 relative to
    each solution's norm: popular items' factors are large, and B1's
    absolute error grows with them."""
    from predictionio_tpu_torch.ops.als import ALSConfig, _normal_system, als_train, pack_tables

    cfg = ALSConfig(rank=GALLERY_ALS["rank"], iterations=GALLERY_ALS["num_iterations"],
                    reg=GALLERY_ALS["lambda_"], implicit=True, alpha=GALLERY_ALS["alpha"],
                    seed=GALLERY_ALS["seed"])
    uf, vf = als_train(users, items, counts, n_users, n_items, cfg, device="cuda")
    tables, block_chunk = pack_tables(users, items, counts, n_users, n_items, cfg, "cuda")
    rows = []
    for side, k, trained, n_side in (("user", 0, vf, n_users), ("item", 4, uf, n_items)):
        opposite = torch.zeros(trained.shape[0] + 1, cfg.rank, device="cuda")
        opposite[:-1] = trained
        A, b = _normal_system(*tables[k : k + 4], opposite, n_side + 1, block_chunk, cfg.reg,
                              True, cfg.alpha, cfg.degree_scaled_reg)
        abs_err, row_rel = b1_errors(torch, A, b)
        if not row_rel <= 1e-4:
            raise AssertionError(f"B1 on the {label} {side} side: row-relative error {row_rel} "
                                 f"(max abs {abs_err})")
        rows.append({"systems": f"{label} {side} side, implicit rank 10", "max_abs_err": abs_err,
                     "max_row_rel_err": row_rel, **b1_times(torch, A, b)})
        del A, b
    for row in rows:
        emit(phase="kernel_real", kernel="spd_cg", **row)
    return rows


def _item_categories(n_items: int, n_categories: int) -> list[frozenset[str]]:
    """One category per item, a second for every third item."""
    return [frozenset({f"c{i % n_categories}"} | ({f"c{(7 * i + 3) % n_categories}"}
                                                  if i % 3 == 0 else set()))
            for i in range(n_items)]


@phase
def similarproduct_phase(torch) -> dict:
    """The multi-events-multi-algos variant at the ML-1M shape (6,040 users x
    3,706 items x 1,000,209 views, a 10 % like subset, 200 categories):
    views-ALS and like-ALS at rank 10, 10 iterations, through B1, and
    cooccurrence n = 20; B1 on the views train's own systems; the views
    model served in batches of 64 queries of 1-5 items with category and
    white/black-list filters, every answer checked against its filters and
    its scores against the plain product."""
    from predictionio_tpu_torch.models.similarproduct import engine as sp
    from predictionio_tpu_torch.ops import cooccurrence, topk
    from predictionio_tpu_torch.utils import native
    from predictionio_tpu_torch.utils.cuda_timing import event_ms
    from predictionio_tpu_torch.workflow.context import WorkflowContext

    n_users, n_items, n_views = 6040, 3706, 1_000_209
    users, items, _ = synthesize_ratings(n_users, n_items, n_views, seed=5)
    rng = np.random.default_rng(31)
    likes = rng.random(len(users)) < 0.1
    cats = _item_categories(n_items, 200)
    td = sp.TrainingData([f"u{i}" for i in range(n_users)], [f"i{i}" for i in range(n_items)],
                         cats, users, items, users[likes], items[likes])
    ctx = WorkflowContext(device="cuda")
    out, launches = {}, {}
    models = {}
    cooccur_before = native.calls["cooccur_topn"]
    for name, algo in (("als", sp.ALSAlgorithm(sp.ALSAlgorithmParams(**GALLERY_ALS))),
                       ("likealgo", sp.LikeAlgorithm(sp.ALSAlgorithmParams(**GALLERY_ALS))),
                       ("cooccurrence", sp.CooccurrenceAlgorithm(sp.CooccurrenceParams(n=20)))):
        model, wall, n_b1 = _counted_train(torch, algo, ctx, td)
        expected = 0 if name == "cooccurrence" else 2 * GALLERY_ALS["num_iterations"]
        if n_b1 != expected:
            raise AssertionError(f"similar-product {name}: B1 launched {n_b1} times, "
                                 f"expected {expected}")
        launches[name] = n_b1
        models[name] = (algo, model)
        out[name] = {"train_wall_s": wall, "spd_cg_launches": n_b1,
                     **{k: v for k, v in (algo.timings or {}).items() if k.endswith("_s")}}
    # the cooccurrence train went through the host library; its map equals
    # the scipy formulation's on the same views
    if native.calls["cooccur_topn"] != cooccur_before + 1:
        raise AssertionError("similar-product cooccurrence did not count through the host library")
    codes = np.unique(users.astype(np.int64) * n_items + items)
    t0 = time.perf_counter()
    scipy_map = cooccurrence._cooccurrence_top_n_scipy(codes // n_items, codes % n_items, n_items, 20)
    out["cooccurrence"]["scipy_s"] = time.perf_counter() - t0
    if models["cooccurrence"][1].top_map != scipy_map:
        raise AssertionError("similar-product cooccurrence differs from the scipy formulation's")
    out["cooccurrence"]["equal_to_scipy"] = True
    pair, counts = np.unique(np.stack([users, items], 1), axis=0, return_counts=True)
    rows = _implicit_b1_rows(torch, pair[:, 0], pair[:, 1], counts.astype(np.float32),
                             n_users, n_items, "ML-1M similar-product views")
    emit(phase="similarproduct_train", shape=[n_users, n_items, n_views],
         likes=int(likes.sum()), categories=200, **out)

    algo, model = models["als"]
    model = algo.prepare_model(WorkflowContext(mode="serving", device="cuda"), model)
    algo.warmup_serving(model, 64)
    popular = np.argsort(-np.bincount(items, minlength=n_items))[:1000]
    all_cats = sorted({c for s in cats for c in s})
    batches = []
    for _ in range(30):
        queries = []
        for r in range(64):
            q_items = tuple(f"i{i}" for i in rng.choice(popular, int(rng.integers(1, 6)), replace=False))
            kw = {}
            if r % 4 == 1:
                kw["categories"] = frozenset(rng.choice(all_cats, 20, replace=False).tolist())
            if r % 5 == 2:
                kw["category_black_list"] = frozenset(rng.choice(all_cats, 20, replace=False).tolist())
            if r % 6 == 3:
                kw["white_list"] = frozenset(f"i{i}" for i in rng.choice(n_items, 400, replace=False))
            if r % 7 == 4:
                kw["black_list"] = frozenset(f"i{i}" for i in popular[:50])
            queries.append(sp.Query(items=q_items, num=10, **kw))
        batches.append(queries)
    lat, results = [], []
    for queries in batches:
        t0 = time.perf_counter()
        results.append(algo.predict_batch_dispatch(model, queries)())
        lat.append((time.perf_counter() - t0) * 1e3)
    table = model.device_factors()
    worst = 0.0
    for queries, served in zip(batches, results):
        for q, res in zip(queries, served):
            got = [s.item for s in res.item_scores]
            qidx = [model.item_index(i) for i in q.items]
            mask = sp.candidate_mask(model, q, qidx)
            if not got or len(got) > q.num or not all(mask[model.item_index(i)] for i in got):
                raise AssertionError(f"similar-product: {got} breaks the filters of {q}")
            scores = torch.where(torch.from_numpy(mask).cuda(), table @ table[qidx].sum(0),
                                 float("-inf"))
            ref = torch.topk(scores, len(got)).values.cpu().numpy()
            worst = max(worst, float(np.abs(np.asarray([s.score for s in res.item_scores]) - ref).max()))
    if not worst <= 1e-5:
        raise AssertionError(f"similar-product served scores off the plain product by {worst}")
    qidx = np.zeros((64, 8), np.int32)
    qidx[:, :3] = rng.choice(popular, (64, 3))
    qw = (qidx > 0).astype(np.float32)
    mask = np.ones((64, n_items), bool)
    ending_ms = event_ms(lambda: topk.gather_sum_top_k_async(table, qidx, qw, mask, 16), reps=50)
    coo_algo, coo_model = models["cooccurrence"]
    t0 = time.perf_counter()
    coo = coo_algo.predict_batch(coo_model, batches[0])
    coo_ms = (time.perf_counter() - t0) * 1e3
    if sum(len(r.item_scores) for r in coo) == 0:
        raise AssertionError("cooccurrence served nothing")
    serve = {"batch": 64, "dispatches": len(batches), "dispatch_p50_ms": float(np.percentile(lat, 50)),
             "dispatch_p99_ms": float(np.percentile(lat, 99)), "max_abs_score_err": worst,
             "gather_sum_ending_ms": ending_ms, "cooccurrence_batch_ms": coo_ms}
    emit(phase="similarproduct_serve", **serve)
    return {"launches": {"similarproduct_views_train": launches["als"],
                         "similarproduct_likes_train": launches["likealgo"]}, "rows": rows}


@phase
def similarproduct_quality_phase(torch) -> dict:
    """The views ALS on the bench's clustered data (2,000 users x 1,000
    items, 20 clusters, 90 % in-cluster): the share of each item's top-10
    similar items in its own cluster, gated at the JAX package's CPU value
    less 0.05."""
    from predictionio_tpu_torch.models.similarproduct import engine as sp
    from predictionio_tpu_torch.workflow.context import WorkflowContext

    tu, ti, _, _ = clustered_recall_data()
    clusters = clustered_item_groups()
    td = sp.TrainingData([f"u{i}" for i in range(2000)], [f"i{i}" for i in range(1000)],
                         [None] * 1000, tu, ti, tu[:0], ti[:0])
    algo = sp.ALSAlgorithm(sp.ALSAlgorithmParams(**GALLERY_ALS))
    model, wall, _ = _counted_train(torch, algo, WorkflowContext(device="cuda"), td)
    share = similar_items_share(algo, model, sp.Query, clusters)
    gate = JAX_CPU_SIMILAR_CLUSTER_SHARE - 0.05
    emit(phase="similarproduct_quality", same_cluster_share_at_10=share, gate=gate,
         jax_cpu_share=JAX_CPU_SIMILAR_CLUSTER_SHARE, chance=1 / 20, train_wall_s=wall)
    if not share > gate:
        raise AssertionError(f"similar-product same-cluster share {share} under the gate {gate}")
    return {"share": share, "gate": gate}


ECOMMERCE_RATES = 125_000
ECOMMERCE_BUYS = ECOMMERCE_VIEWS = 50_000


@phase
def ecommerce_phase(torch, home: str) -> dict:
    """bench.py:660's e-commerce shape: 20,000 users x 10,000 items; 125,000
    rate events (the template trains on rates; an eighth of the bench's
    1,000,000, to keep the script within its time) and 50,000 buys of 19,000
    known users, 50,000 views of known users and 500 cold users, 500 cold
    users with no events, 50 categories, an unavailableItems constraint of
    50 items and a weightedItems constraint, imported with import_events into
    the port's sqlite store (live reads go to it, through its (entityType,
    entityId) index). Trains rank 10 at 10 iterations, and 20 for
    adjust-score, through B1; serves batches of 64 (48 known users, 8 cold
    with views, 8 cold without) at cacheTtlS 0 and 60, counting store
    reads in a second pass over the same batches (a positive TTL's cache
    then holds every user's reads); no seen or unavailable item may come
    back, and adjust-score's scores are the plain product times the weight."""
    import datetime as dt

    from predictionio_tpu_torch.data.storage.base import App
    from predictionio_tpu_torch.data.store.event_store import LEventStore
    from predictionio_tpu_torch.models.ecommerce import engine as ec
    from predictionio_tpu_torch.ops import topk
    from predictionio_tpu_torch.tools.import_export import import_events
    from predictionio_tpu_torch.utils.cuda_timing import event_ms
    from predictionio_tpu_torch.workflow.context import WorkflowContext

    n_users, n_known, n_items = 20_000, 19_000, 10_000
    t0 = time.perf_counter()
    ru, ri, rv = synthesize_ratings(n_known, n_items, ECOMMERCE_RATES, seed=7)
    rng = np.random.default_rng(37)
    bu = rng.integers(0, n_known, ECOMMERCE_BUYS).astype(np.int32)
    bi = (rng.zipf(1.3, ECOMMERCE_BUYS) % n_items).astype(np.int32)
    vu = np.where(rng.random(ECOMMERCE_VIEWS) < 0.8, rng.integers(0, n_known, ECOMMERCE_VIEWS),
                  rng.integers(n_known, n_known + 500, ECOMMERCE_VIEWS)).astype(np.int32)
    vi = (rng.zipf(1.3, ECOMMERCE_VIEWS) % n_items).astype(np.int32)
    cats = [frozenset({f"c{i % 50}"}) for i in range(n_items)]
    unavailable = [f"i{i}" for i in rng.choice(n_items, 50, replace=False)]
    up, down = rng.choice(n_items, 150, replace=False).reshape(2, 75)
    weights_prop = [{"items": [f"i{i}" for i in up], "weight": 2.0},
                    {"items": [f"i{i}" for i in down], "weight": 0.5}]
    storage = smoke_storage(os.path.join(home, "ecom"))
    storage.get_meta_data_apps().insert(App(0, "ecomapp"))
    path = os.path.join(home, "ecom", "events.jsonl")
    t_base = dt.datetime(2024, 1, 1, tzinfo=dt.timezone.utc).timestamp()

    def when(k):
        return dt.datetime.fromtimestamp(t_base + k * 1e-3, dt.timezone.utc).isoformat(
            timespec="milliseconds").replace("+00:00", "Z")

    def line(k, event, u, i, props="{}"):
        t = when(k)
        return (f'{{"creationTime": "{t}", "entityId": "u{u}", "entityType": "user", "event": '
                f'"{event}", "eventId": "{event[0]}{k}", "eventTime": "{t}", "properties": {props}, '
                f'"targetEntityId": "i{i}", "targetEntityType": "item"}}\n')

    k = 0
    lines = []
    for i in range(n_items):
        t = when(k)
        lines.append(json.dumps({"creationTime": t, "entityId": f"i{i}", "entityType": "item",
                                 "event": "$set", "eventId": f"s{k}", "eventTime": t,
                                 "properties": {"categories": sorted(cats[i])}}) + "\n")
        k += 1
    for name, us, its, vals in (("rate", ru, ri, rv), ("buy", bu, bi, None), ("view", vu, vi, None)):
        for n, (u, i) in enumerate(zip(us.tolist(), its.tolist())):
            props = f'{{"rating": {vals[n]}}}' if vals is not None else "{}"
            lines.append(line(k, name, u, i, props))
            k += 1
    for entity, props in (("unavailableItems", {"items": unavailable}),
                          ("weightedItems", {"weights": weights_prop})):
        t = when(k)
        lines.append(json.dumps({"creationTime": t, "entityId": entity, "entityType": "constraint",
                                 "event": "$set", "eventId": f"c{k}", "eventTime": t,
                                 "properties": props}) + "\n")
        k += 1
    with open(path, "w") as fh:
        fh.writelines(lines)
    del lines
    data_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    imported = import_events(path, "ecomapp", storage=storage)
    import_s = time.perf_counter() - t0
    if imported != k:
        raise AssertionError(f"e-commerce import: {imported} of {k} events")
    td = ec.TrainingData([f"u{i}" for i in range(n_known)], [f"i{i}" for i in range(n_items)],
                         cats, ru, ri, rv, bu, bi)
    ctx = WorkflowContext(device="cuda", _storage=storage, app_name="ecomapp")
    base = dict(GALLERY_ALS, app_name="ecomapp", unseen_only=True)
    trained, launches, train_out = {}, {}, {}
    for name, params in (("default", ec.ECommAlgorithmParams(**base)),
                         ("adjust-score", ec.ECommAlgorithmParams(**dict(
                             base, num_iterations=20, adjust_score=True)))):
        algo = ec.ECommAlgorithm(params)
        model, wall, n_b1 = _counted_train(torch, algo, ctx, td)
        if n_b1 != 2 * params.num_iterations:
            raise AssertionError(f"e-commerce {name}: B1 launched {n_b1} times")
        trained[name] = algo.prepare_model(ctx, model)
        launches[name] = n_b1
        train_out[name] = {"train_wall_s": wall, "spd_cg_launches": n_b1,
                           **{k: v for k, v in algo.timings.items() if k.endswith("_s")}}
    emit(phase="ecommerce_train", shape=[n_users, n_items, ECOMMERCE_RATES, ECOMMERCE_BUYS, ECOMMERCE_VIEWS],
         events_in_store=k, data_s=data_s, import_s=import_s, import_events_per_s=k / import_s,
         backend="sqlite", **train_out)

    t0 = time.perf_counter()
    list(ctx.l_event_store().find_by_entity(app_name="ecomapp", entity_type="user", entity_id="u0"))
    first_read_s = time.perf_counter() - t0
    unavail = set(unavailable)
    batches = []
    for _ in range(12):
        us = np.concatenate([rng.integers(0, n_known, 48), rng.integers(n_known, n_known + 500, 8),
                             rng.integers(n_known + 500, n_users, 8)])
        queries = []
        for r, u in enumerate(us.tolist()):
            kw = {"categories": frozenset({f"c{r % 50}", f"c{(r + 7) % 50}"})} if r % 5 == 0 else {}
            queries.append(ec.Query(user=f"u{u}", num=10, **kw))
        batches.append(queries)
    serve = {"first_read_s": first_read_s}
    reads = []  # seconds of each store read, the events decoded included
    real_find = LEventStore.find_by_entity

    def counted_find(self, **kw):
        t = time.perf_counter()
        events = list(real_find(self, **kw))
        reads.append(time.perf_counter() - t)
        return iter(events)

    LEventStore.find_by_entity = counted_find
    try:
        for name, model in trained.items():
            for ttl in (0.0, 60.0):
                params = ec.ECommAlgorithmParams(**dict(
                    base, num_iterations=20 if name != "default" else 10,
                    adjust_score=name != "default", cache_ttl_s=ttl))
                algo = ec.ECommAlgorithm(params)
                algo.warmup_serving(model, 64)
                reads.clear()
                for queries in batches:  # a first pass fills a positive TTL's cache
                    algo.predict_batch(model, queries)
                first_reads = len(reads)
                lat, results = [], []
                reads.clear()
                for queries in batches[1:]:
                    t0 = time.perf_counter()
                    results.append(algo.predict_batch_dispatch(model, queries)())
                    lat.append((time.perf_counter() - t0) * 1e3)
                n_reads = len(reads)
                read_ms = float(np.mean(reads) * 1e3) if reads else None
                for queries, served in zip(batches[1:], results):
                    for q, res in zip(queries, served):
                        got = {s.item for s in res.item_scores}
                        seen = algo._seen_items_live(ctx, q.user)
                        if len(res.item_scores) != 10 or got & unavail or got & seen:
                            raise AssertionError(f"e-commerce {name}: {sorted(got)} for {q}")
                        if q.categories and not all(cats[int(i[1:])] & q.categories for i in got):
                            raise AssertionError(f"e-commerce {name}: category filter broken")
                n_q = 64 * (len(batches) - 1)
                serve[f"{name}_ttl_{int(ttl)}"] = {
                    "dispatch_p50_ms": float(np.percentile(lat, 50)),
                    "dispatch_p99_ms": float(np.percentile(lat, 99)),
                    "store_reads_per_query": n_reads / n_q,
                    "store_read_mean_ms": read_ms,
                    "first_pass_store_reads_per_query": first_reads / (64 * len(batches))}
                if ttl > 0 and n_reads != 0:
                    raise AssertionError(f"e-commerce at cacheTtlS {ttl}: {n_reads} store reads")
    finally:
        LEventStore.find_by_entity = real_find
    model = trained["adjust-score"]
    algo = ec.ECommAlgorithm(ec.ECommAlgorithmParams(**dict(base, adjust_score=True)))
    weights = algo._item_weights_live(ctx, model)
    worst = 0.0
    for q, res in zip(batches[1][:48], algo.predict_batch(model, batches[1][:48])):
        u = model.user_index(q.user)
        for s in res.item_scores:
            i = model.item_index(s.item)
            plain = float(model.user_factors[u].astype(np.float64) @ model.item_factors[i])
            worst = max(worst, abs(s.score - plain * weights[i]) / max(abs(plain * weights[i]), 1e-6))
    if not worst <= 1e-5:
        raise AssertionError(f"adjust-score: weighted scores off plain x weight by {worst}")
    table = model.device_items()
    vecs = np.ascontiguousarray(model.user_factors[:64])
    mask = np.ones((64, n_items), bool)
    serve["weighted_dot_ending_ms"] = event_ms(
        lambda: topk.dot_top_k_async(table, vecs, mask, 16, weights=weights), reps=50)
    serve["adjust_score_max_rel_err"] = worst
    emit(phase="ecommerce_serve", batch=64, dispatches=len(batches) - 1, **serve)
    return {"launches": {"ecommerce_train": launches["default"],
                         "ecommerce_adjust_score_train": launches["adjust-score"]}}


@phase
def recommendeduser_phase(torch) -> dict:
    """A follow graph of 50,000 users in 50 communities with 1,000,000
    follows (90 % inside the community): implicit ALS at rank 10, 10
    iterations, through B1; 2,048 users served in batches of 64; the
    same-community share of their top-10 gated at the JAX package's CPU
    value on the small graph less 0.05."""
    from predictionio_tpu_torch.models.recommendeduser import engine as ru
    from predictionio_tpu_torch.workflow.context import WorkflowContext

    n_users, n_comm, n_follows = 50_000, 50, 1_000_000
    follower, followed = follow_graph(n_users, n_comm, n_follows, seed=8)
    vocab = [f"u{i}" for i in range(n_users)]
    td = ru.TrainingData(vocab, vocab, follower, followed)
    algo = ru.ALSAlgorithm(ru.ALSAlgorithmParams(**GALLERY_ALS))
    ctx = WorkflowContext(device="cuda")
    model, wall, n_b1 = _counted_train(torch, algo, ctx, td)
    if n_b1 != 2 * GALLERY_ALS["num_iterations"]:
        raise AssertionError(f"recommended-user: B1 launched {n_b1} times")
    timings = {k: v for k, v in algo.timings.items() if k.endswith("_s")}
    model = algo.prepare_model(WorkflowContext(mode="serving", device="cuda"), model)
    algo.warmup_serving(model, 64)
    users = np.random.default_rng(41).choice(n_users, 2048, replace=False)
    lat = []
    for s in range(0, 2048, 64):
        queries = [ru.Query(users=(f"u{u}",), num=10) for u in users[s : s + 64]]
        t0 = time.perf_counter()
        algo.predict_batch_dispatch(model, queries)()
        lat.append((time.perf_counter() - t0) * 1e3)
    share = similar_users_share(algo, model, ru.Query, users, n_comm)
    gate = JAX_CPU_FOLLOW_COMMUNITY_SHARE - 0.05
    emit(phase="recommendeduser", shape=[n_users, n_comm, len(follower)], train_wall_s=wall,
         spd_cg_launches=n_b1, **timings, dispatch_p50_ms=float(np.percentile(lat, 50)),
         dispatch_p99_ms=float(np.percentile(lat, 99)), same_community_share_at_10=share,
         gate=gate, jax_cpu_share=JAX_CPU_FOLLOW_COMMUNITY_SHARE,
         jax_cpu_graph=list(FOLLOW_GATE_GRAPH), chance=1 / n_comm)
    if not share > gate:
        raise AssertionError(f"recommended-user same-community share {share} under {gate}")
    return {"launches": {"recommendeduser_train": n_b1}}


def _nb_host_labels(model, X: np.ndarray):
    """The float64 host labels of naive Bayes, and where the top two scores
    lie within 1e-5 relative (a float32 score may order them otherwise)."""
    scores = model.log_priors[None, :] + np.asarray(X, np.float64) @ model.log_theta.T
    top2 = np.sort(scores, axis=1)[:, -2:]
    near = (top2[:, 1] - top2[:, 0]) <= 1e-5 * np.abs(top2[:, 1])
    return model.labels[np.argmax(scores, axis=1)], near


@phase
def classification_phase(torch, home: str) -> dict:
    """Naive Bayes at bench.py:2461's shape (200,000 points x 64 features x
    8 classes): scores and argmax of the 200,000 points on the card against
    the float64 host labels (equal except where the top two scores lie
    within 1e-5 relative); then the add-algorithm variant (naive Bayes and
    the forest) through Engine.train from 1,000 points in the store."""
    from predictionio_tpu_torch.data.event import Event
    from predictionio_tpu_torch.data.storage.base import App
    from predictionio_tpu_torch.models.classification import engine as cl
    from predictionio_tpu_torch.ops.classify import _nb_scores, train_naive_bayes
    from predictionio_tpu_torch.utils.cuda_timing import event_ms
    from predictionio_tpu_torch.workflow.context import WorkflowContext

    rng = np.random.default_rng(0)
    labels = rng.integers(0, 8, 200_000).astype(np.float64)
    feats = rng.poisson(2.0, size=(200_000, 64)).astype(np.float64)
    t0 = time.perf_counter()
    model = train_naive_bayes(labels, feats, 1.0)
    train_s = time.perf_counter() - t0
    model.device = "cuda"
    model.predict_batch(feats[:8])  # the tables onto the card
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = model.predict_batch(feats)
    predict_s = time.perf_counter() - t0
    want, near = _nb_host_labels(model, feats)
    wrong = int(np.sum((got != want) & ~near))
    lp, lt = model.device_params()
    x = torch.from_numpy(feats.astype(np.float32)).cuda()
    scores_ms = event_ms(lambda: torch.argmax(_nb_scores(lp, lt, x), dim=1), reps=20)
    emit(phase="classification_nb", shape=[200_000, 64, 8], train_s=train_s,
         predict_batch_s=predict_s, nb_scores_argmax_ms=scores_ms,
         label_mismatches=int(np.sum(got != want)), near_ties=int(near.sum()),
         mismatches_outside_ties=wrong)
    if wrong:
        raise AssertionError(f"naive Bayes on the card: {wrong} labels differ outside near ties")
    storage = smoke_storage(os.path.join(home, "cls"))
    app_id = storage.get_meta_data_apps().insert(App(0, "clsapp"))
    c = rng.integers(0, 3, 1000)
    storage.get_l_events().insert_batch([
        Event("$set", "user", f"u{p}", properties={
            "plan": float(c[p]), **{f"attr{j}": float(rng.poisson(2 + 3 * ((c[p] + j) % 3)))
                                    for j in range(3)}})
        for p in range(1000)], app_id)
    engine = cl.engine_factory()
    ep = engine.engine_params_from_variant({
        "datasource": {"params": {"appName": "clsapp"}},
        "algorithms": [{"name": "naive", "params": {"lambda": 1.0}},
                       {"name": "randomforest", "params": {"numTrees": 10, "maxDepth": 4,
                                                           "seed": 42}}]})
    ctx = WorkflowContext(device="cuda", _storage=storage, app_name="clsapp")
    t0 = time.perf_counter()
    models = engine.prepare_deploy(ctx, ep, engine.train(ctx, ep))
    train2_s = time.perf_counter() - t0
    _, _, algos, _ = engine.make_components(ep)
    X = rng.poisson(4, size=(200, 3)).astype(np.float64)
    queries = [cl.Query(*x) for x in X]
    nb = [algos[0].predict(models[0], q).label for q in queries]
    rf = [algos[1].predict(models[1], q).label for q in queries]
    agree_nb_rf = float(np.mean(np.asarray(nb) == np.asarray(rf)))
    want, near = _nb_host_labels(models[0], X)
    if np.any((models[0].predict_batch(X) != np.asarray(nb)) & ~near) or not set(rf) <= {0.0, 1.0, 2.0}:
        raise AssertionError("add-algorithm: device labels differ from the host's, or bad labels")
    emit(phase="classification_add_algorithm", points=1000, train_s=train2_s,
         nb_forest_agreement=agree_nb_rf)
    return {}


# ---------------------------------------------------------------------------
# The four templates through the CLI
# ---------------------------------------------------------------------------


def _gallery_event_lines(template: str, rng) -> tuple[list[dict], list[dict]]:
    """ML-100K-shape events of a template (1,000 points for classification)
    and 200 queries for it."""
    n_users, n_items = 943, 1682
    events: list[dict] = []

    def ev(k, event, entity_type, entity_id, target=None, props=None, target_type="item"):
        d = {"event": event, "entityType": entity_type, "entityId": entity_id,
             "eventTime": f"2024-01-01T{k // 3600000 % 24:02d}:{k // 60000 % 60:02d}:"
                          f"{k // 1000 % 60:02d}.{k % 1000:03d}Z", "eventId": f"e{k}"}
        if target is not None:
            d.update(targetEntityType=target_type, targetEntityId=target)
        if props is not None:
            d["properties"] = props
        events.append(d)

    k = 0
    if template == "classification":
        for p in range(1000):
            c = int(rng.integers(3))
            ev(k, "$set", "user", f"u{p}", props={"plan": float(c), **{
                f"attr{j}": float(rng.poisson(2 + 3 * ((c + j) % 3))) for j in range(3)}})
            k += 1
        queries = [{f"attr{j}": float(x) for j, x in enumerate(rng.poisson(4, 3))}
                   for _ in range(200)]
        return events, queries
    if template == "recommendeduser":
        follower, followed = follow_graph(n_users, 23, 100_000, seed=9)
        for u, v in zip(follower.tolist(), followed.tolist()):
            ev(k, "follow", "user", f"u{u}", f"u{v}", target_type="user")
            k += 1
        queries = [{"users": [f"u{u}" for u in rng.choice(n_users, int(rng.integers(1, 4)))],
                    "num": 10} for _ in range(200)]
        return events, queries
    users, items, vals = synthesize_ratings(n_users, n_items, 100_000, seed=11)
    for i in range(n_items):
        ev(k, "$set", "item", f"i{i}", props={"categories": [f"c{i % 20}"]})
        k += 1
    if template == "similarproduct":
        likes = rng.random(len(users)) < 0.1
        for u, i, like in zip(users.tolist(), items.tolist(), likes.tolist()):
            ev(k, "like" if like else "view", "user", f"u{u}", f"i{i}")
            k += 1
        queries = [{"items": [f"i{i}" for i in rng.choice(400, int(rng.integers(1, 4)), replace=False)],
                    "num": 10, **({"categories": ["c1", "c2", "c3"]} if q % 4 == 0 else {})}
                   for q in range(200)]
        return events, queries
    for u, i, r in zip(users.tolist(), items.tolist(), vals.tolist()):
        ev(k, "rate", "user", f"u{u}", f"i{i}", props={"rating": r})
        k += 1
    for u, i in zip(rng.integers(0, n_users, 5000).tolist(), rng.integers(0, n_items, 5000).tolist()):
        ev(k, "buy", "user", f"u{u}", f"i{i}")
        k += 1
    for u, i in zip(rng.integers(0, n_users + 50, 5000).tolist(), rng.integers(0, n_items, 5000).tolist()):
        ev(k, "view", "user", f"u{u}", f"i{i}")
        k += 1
    ev(k, "$set", "constraint", "unavailableItems", props={"items": [f"i{i}" for i in range(0, 100, 10)]})
    queries = [{"user": f"u{u}", "num": 10} for u in rng.integers(0, n_users + 100, 200)]
    return events, queries


def _check_gallery_answer(template: str, query: dict, body: dict) -> None:
    if template == "classification":
        if set(body) != {"label"} or body["label"] not in (0.0, 1.0, 2.0):
            raise AssertionError(f"classification answered {body}")
        return
    key, id_key = (("similarUserScores", "user") if template == "recommendeduser"
                   else ("itemScores", "item"))
    rows = body[key]
    if set(body) != {key} or len(rows) > query.get("num", 10):
        raise AssertionError(f"{template} answered {body}")
    scores = [r["score"] for r in rows]
    if any(not (isinstance(r[id_key], str) and np.isfinite(r["score"])) for r in rows) or \
            scores != sorted(scores, reverse=True):
        raise AssertionError(f"{template}: malformed answer {body}")
    own = set(query.get("items", [])) | set(query.get("users", []))
    if own & {r[id_key] for r in rows}:
        raise AssertionError(f"{template}: a query's own id was served: {body}")
    if template == "ecommerce" and {r["item"] for r in rows} & {f"i{i}" for i in range(0, 100, 10)}:
        raise AssertionError(f"e-commerce served an unavailable item: {body}")


GALLERY_CLI = {
    # template -> the JAX package's engine.json (or variant) it deploys from
    "similarproduct": "predictionio_tpu/models/similarproduct/variants/multi-events-multi-algos.json",
    "ecommerce": "predictionio_tpu/models/ecommerce/engine.json",
    "recommendeduser": "predictionio_tpu/models/recommendeduser/engine.json",
    "classification": "predictionio_tpu/models/classification/variants/add-algorithm.json",
}


def gallery_cli_setup(home: str, template: str, device: str = "cuda") -> dict:
    """app new -> import -> train through the port's CLI from the JAX
    package's engine.json for the template (its engineFactory string)."""
    rng = np.random.default_rng(17)
    events, queries = _gallery_event_lines(template, rng)
    work = work_dir(prefix=f"pio_smoke_{template}_")
    path = os.path.join(work, "events.jsonl")
    with open(path, "w") as fh:
        fh.writelines(json.dumps(e) + "\n" for e in events)
    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, GALLERY_CLI[template])) as fh:
        variant = json.load(fh)
    app = f"{template}app"
    variant["datasource"]["params"]["appName"] = app
    for algo in variant["algorithms"]:
        if "appName" in algo["params"]:
            algo["params"]["appName"] = app
    engine_dir = os.path.join(work, "engine")
    os.makedirs(engine_dir)
    with open(os.path.join(engine_dir, "engine.json"), "w") as fh:
        json.dump(variant, fh)
    cli, env, run = _cli(os.path.join(home, template))
    steps = {"app_new_s": run("app", "new", app),
             "import_s": run("import", "--appname", app, "--input", path),
             "train_s": run("train", "--engine-dir", engine_dir, "--device", device)}
    return {"template": template, "work": work, "engine_dir": engine_dir, "cli": cli, "env": env,
            "queries": queries, "events": len(events), "steps": steps,
            "engine_factory": variant["engineFactory"]}


def gallery_cli_serve(setup: dict, server, base: str, ready_s: float) -> dict:
    """200 queries to a deployed server: 40 one at a time, 160 from 32
    clients at once; every answer a 200 and well formed."""
    template = setup["template"]
    queries = setup["queries"]
    try:
        outs = [_http(base + "/queries.json", q) for q in queries[:40]]
        with concurrent.futures.ThreadPoolExecutor(32) as pool:
            outs += list(pool.map(lambda q: _http(base + "/queries.json", q), queries[40:]))
        for q, (status, body, _) in zip(queries, outs):
            if status != 200:
                raise AssertionError(f"{template}: {q} answered {status}")
            _check_gallery_answer(template, q, body)
        _, st, _ = _http(base + "/")
    finally:
        _stop(server)
        remove_work(setup["work"])
    lat_ms = np.asarray([dt for _, _, dt in outs]) * 1e3
    result = {**setup["steps"], "deploy_ready_s": ready_s, "requests": len(outs), "all_200": True,
              "p50_ms": float(np.percentile(lat_ms, 50)), "p99_ms": float(np.percentile(lat_ms, 99)),
              "largest_batch": st["largestBatch"], "batches": st["batches"],
              "events": setup["events"], "engine_factory": setup["engine_factory"]}
    emit(phase=f"{template}_cli", **result)
    return result


@phase
def gallery_cli_phase(home: str, device: str = "cuda") -> dict:
    """The four templates through the CLI: their imports, trains and
    deploys run side by side (independent processes and stores), then each
    server is queried alone, so that latencies see one busy server at a
    time."""
    with concurrent.futures.ThreadPoolExecutor(len(GALLERY_CLI)) as pool:
        setups = list(pool.map(lambda t: gallery_cli_setup(home, t, device), GALLERY_CLI))
        started = [pool.submit(_start_deploy, s["cli"], s["env"], s["engine_dir"], s["work"],
                               device) for s in setups]
    try:
        return {s["template"]: gallery_cli_serve(s, *f.result()) for s, f in zip(setups, started)}
    finally:  # every server that started, whichever failed
        for f in started:
            if f.exception() is None:
                _stop(f.result()[0])


# ---------------------------------------------------------------------------
# The offline verbs: pio batchpredict and pio eval
# ---------------------------------------------------------------------------


def _same_topk(got_ids, got_scores, ref_ids, ref_scores, rtol: float, what: str) -> None:
    """Row by row: the first k scores within ``rtol`` relative of the
    reference's, and every served id one the reference scores the same,
    within ``rtol`` (ids compared as sets within a run of tied scores; the
    reference holds more than k columns, so a tie cut at k is seen)."""
    k = got_ids.shape[1]
    np.testing.assert_allclose(got_scores, ref_scores[:, :k], rtol=rtol, atol=0, err_msg=what)
    match = got_ids[:, :, None] == ref_ids[:, None, :]
    if not match.any(axis=2).all():
        bad = int(np.flatnonzero(~match.any(axis=2).all(axis=1))[0])
        raise AssertionError(f"{what}: row {bad} served {got_ids[bad]}, the reference "
                             f"{ref_ids[bad]}")
    np.testing.assert_allclose((match * ref_scores[:, None, :]).sum(axis=2), got_scores,
                               rtol=rtol, atol=0, err_msg=what)


@phase
def batchpredict_als_phase(torch, model) -> dict:
    """The ML-20M model through the offline pipeline: a 69,000-line query
    file (one query for every other user, num 10) in mega-batches of 512 into a
    FileSink and a MemorySink; every row ok and line-aligned, and each
    row's top-10 equal to ServingIndex.serve_batch for that row's user (a
    torn read of the reused staging buffer would serve another user)."""
    from predictionio_tpu_torch.models.recommendation import engine as rec
    from predictionio_tpu_torch.workflow.batch_predict import (
        FileSink, MemorySink, iter_query_file, run_pipeline)

    users = model.user_vocab[::2]  # every other user: half the ML-20M users, to fit the script's time
    n_users, k = len(users), 10
    work = work_dir(prefix="pio_smoke_bp_")
    try:
        qpath, out = os.path.join(work, "queries.jsonl"), os.path.join(work, "out.jsonl")
        with open(qpath, "w") as fh:
            fh.writelines(json.dumps({"user": u, "num": k}) + "\n" for u in users)
        sink = MemorySink()
        algo = rec.ALSAlgorithm(rec.ALSAlgorithmParams(rank=model.user_factors.shape[1]))
        report = run_pipeline(rec.engine_factory(), (None, None, [algo], rec.Serving()), [model],
                              iter_query_file(qpath), [FileSink(out), sink], batch_size=512)
        with open(out) as fh:
            lines = fh.read().splitlines()
    finally:
        remove_work(work)
    if report.queries != n_users or report.ok != n_users or report.errors:
        raise AssertionError(f"batchpredict: {report.queries} queries, {report.ok} ok")
    if [r.lineno for r in sink.rows] != list(range(1, n_users + 1)) or len(lines) != n_users:
        raise AssertionError("batchpredict rows are not line-aligned in source order")
    if any(json.loads(line) != row.result for line, row in zip(lines[:1000], sink.rows)):
        raise AssertionError("the file sink's lines differ from the served rows")
    got_ids = np.asarray([[model.item_index(x["item"]) for x in r.result["itemScores"]]
                          for r in sink.rows])
    got_scores = np.asarray([[x["score"] for x in r.result["itemScores"]] for r in sink.rows])
    if got_ids.shape != (n_users, k):
        raise AssertionError(f"batchpredict rows of shape {got_ids.shape}")
    index = model.serving_index()
    for lo in range(0, n_users, 4096):
        rows = np.arange(lo, min(lo + 4096, n_users))
        ref_scores, ref_ids = index.serve_batch((2 * rows).astype(np.int32), 2 * k)
        _same_topk(got_ids[rows], got_scores[rows], ref_ids, ref_scores, 1e-5,
                   f"batchpredict rows {lo}..")
    result = {"host_numbers": True, "queries": report.queries, "batches": report.batches,
              "batch_size": 512, "wall_s": report.wall_s, "users_per_s": report.users_per_s,
              "tiling_ratio": report.tiling_ratio, "phase_p50_ms": report.phase_p50_ms,
              "phase_total_s": report.phase_total_s, "rows_equal_serve_batch": n_users}
    emit(phase="batchpredict_als", shape=[n_users, len(model.item_vocab)], **result)
    return result


def attention_row(torch, name: str, x, label: str) -> dict:
    """One kernel at one shape, timed as the serving rows are: eager calls
    (``ms``), a replayed CUDA graph (``graph_ms``), the plain version, SDPA
    on bf16 as the yardstick; beside the bound."""
    from predictionio_tpu_torch.ops import attention as A
    from predictionio_tpu_torch.utils.cuda_timing import event_ms, graph_ms

    wrapper, plain = attention_kernels(A)[name]
    err = float((wrapper(x, x, x, True) - plain(x, x, x, True)).abs().max())
    if not err <= ATTENTION_ATOL:
        raise AssertionError(f"{name} at {list(x.shape)}: max abs err {err}")
    xb = x.to(torch.bfloat16)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    bound_ms, bound_by, bounds = attention_bound_ms(x, x, x, True)
    row = {
        "kernel": name, "shape": list(x.shape), "label": label, "max_abs_err": err,
        "ms": event_ms(lambda: wrapper(x, x, x, True), reps=20),
        "graph_ms": graph_ms(lambda: wrapper(x, x, x, True)),
        "plain_ms": event_ms(lambda: plain(x, x, x, True), reps=3),
        "library_ms": event_ms(lambda: sdpa(xb, xb, xb, is_causal=True), reps=20),
        "library_graph_ms": graph_ms(lambda: sdpa(xb, xb, xb, is_causal=True)),
        "bound_ms": bound_ms, "bound_by": bound_by, "bounds_ms": bounds,
    }
    emit(phase="kernel_attention_real", causal=True, **row)
    return row


@phase
def batchpredict_sequential_phase(torch, model, sessions) -> dict:
    """The ML-1M attention model through the offline pipeline: all 6,040
    users (their last ``context`` items as recentItems) at context 200
    (B2) and 1024 (B3) in mega-batches of 512; the kernel's launches read
    around each run equal the mega-batches; every answer equal to
    predict_batch_dispatch's in batches of 64; each kernel timed at the
    mega-batch shape."""
    from predictionio_tpu_torch.models.sequential import engine as seq
    from predictionio_tpu_torch.ops import attention as A
    from predictionio_tpu_torch.workflow.batch_predict import MemorySink, run_pipeline

    vocab, n_users, batch = model.item_vocab, len(sessions), 512
    n_batches = -(-n_users // batch)
    table_in = model.device_in()
    launches: dict[str, dict[str, int]] = {"attention_block": {}, "flash_attention": {}}
    rows = []
    for context, name in ((200, "attention_block"), (1024, "flash_attention")):
        if A.route(context, context) != ("block" if name == "attention_block" else "flash"):
            raise AssertionError(f"context {context} does not route to {name}")
        algo = seq.AttentionAlgorithm(seq.AttentionAlgorithmParams(rank=32, context=context))
        payloads = [{"user": f"u{u}", "recentItems": [vocab[i] for i in s[-context:]], "num": 10}
                    for u, s in enumerate(sessions)]
        algo.warmup_serving(model, batch)
        torch.cuda.synchronize()
        A.fused_attention_block.launches = 0
        A.flash_attention.launches = 0
        sink = MemorySink()
        report = run_pipeline(seq.engine_factory(), (None, None, [algo], seq.Serving()), [model],
                              enumerate(payloads, 1), [sink], batch_size=batch, warmup=False)
        counts = {"attention_block": A.fused_attention_block.launches,
                  "flash_attention": A.flash_attention.launches}
        if counts[name] != n_batches or sum(counts.values()) != n_batches:
            raise AssertionError(f"batchpredict at context {context}: launches {counts}, "
                                 f"expected {n_batches} of {name}")
        launches[name][f"batchpredict_context_{context}"] = counts[name]
        if report.ok != n_users or [r.lineno for r in sink.rows] != list(range(1, n_users + 1)):
            raise AssertionError(f"context {context}: {report.ok} of {n_users} rows ok")
        queries = [seq.Query.from_json_dict(p) for p in payloads]
        ref = []
        for lo in range(0, n_users, 64):
            ref.extend(algo.predict_batch_dispatch(model, queries[lo : lo + 64])())
        index = model.item_index()
        differ = 0
        for r, (row, want) in enumerate(zip(sink.rows, ref)):
            got_ids = [index[x["item"]] for x in row.result["itemScores"]]
            got_scores = np.asarray([x["score"] for x in row.result["itemScores"]])
            ref_ids = [index[x.item] for x in want.item_scores]
            ref_scores = np.asarray([x.score for x in want.item_scores])
            if not got_ids or len(got_ids) != len(ref_ids):
                raise AssertionError(f"context {context}, user {r}: {len(got_ids)} items "
                                     f"against {len(ref_ids)}")
            np.testing.assert_allclose(got_scores, ref_scores, rtol=ATTENTION_ATOL, atol=0)
            if set(got_ids) != set(ref_ids):
                # a tie cut at the last place may hold another member of the tie
                differ += 1
                tied = np.abs(ref_scores - ref_scores[-1]) <= ATTENTION_ATOL * abs(ref_scores[-1])
                if set(np.asarray(got_ids)[~tied]) != set(np.asarray(ref_ids)[~tied]):
                    raise AssertionError(f"context {context}, user {r}: {got_ids} against {ref_ids}")
        hist, _, _, _ = algo._stage_batch(model, queries[:batch])
        x = table_in[torch.from_numpy(hist.copy()).cuda()].unsqueeze(1)
        rows.append(attention_row(torch, name, x, f"sequential batchpredict, context {context}"))
        emit(phase="batchpredict_sequential", context=context, batch_size=batch,
             batches=report.batches, launches=counts, wall_s=report.wall_s,
             users_per_s=report.users_per_s, phase_p50_ms=report.phase_p50_ms,
             rows_differing_in_tied_ids=differ, host_numbers=True)
    return {"launches": launches, "rows": rows}


_GRID_EVALUATION = """
from predictionio_tpu_torch.eval import Evaluation
from predictionio_tpu_torch.models.recommendation.engine import engine_factory
from predictionio_tpu_torch.tuning.metrics import PrecisionAtK

VARIANT = {variant!r}


def make_evaluation():
    engine = engine_factory()
    params = []
    for rank in (10, 20):
        for lam in (0.01, 0.1):
            v = {{**VARIANT, "algorithms": [{{"name": "als", "params": {{
                **VARIANT["algorithms"][0]["params"], "rank": rank, "lambda": lam}}}}]}}
            params.append(engine.engine_params_from_variant(v))
    return Evaluation(engine=engine, metric=PrecisionAtK(k=10), engine_params_generator=params)
"""


@phase
def offline_cli_phase(torch, home: str, rest: dict, device: str = "cuda") -> dict:
    """The offline verbs as a user runs them, each a process of the port's
    CLI on the event server's sqlite store: batchpredict --from-events
    --to-events (one line and one write-back event per user, read back
    through LEventStore), undeploy of a deployed server (which exits 0
    within 10 s), status, version and template list. Then eval of the
    recommendation template, rank {10, 20} x lambda {0.01, 0.1} x 2 folds =
    8 cells scored by PrecisionAtK(10): in-process (--workers 0, B1's
    launches read: 8 x 2 x iterations), with 2 spawned workers into a
    fresh workdir (the same cell ids, each params' score within 0.02), and
    --resume over that workdir (0 cells retrained). No process imports
    JAX, the JAX package or aiohttp."""
    from predictionio_tpu_torch.data.store.event_store import LEventStore

    work = work_dir(prefix="pio_smoke_offline_")
    env = {**os.environ, "PYTHONPATH": os.path.dirname(os.path.abspath(__file__))}
    reports, steps = [], {}

    reports_lock = threading.Lock()  # the info verbs run on a thread of their own

    def argv(*args):
        with reports_lock:
            reports.append(os.path.join(work, f"report_{len(reports)}.json"))
            report = reports[-1]
        return [sys.executable, "-c", _CLI_LAUNCHER, report, "--home", home, *args]

    def run(name, *args, timeout=600):
        t0 = time.perf_counter()
        command = argv(*args)
        proc = subprocess.run(command, env=env, capture_output=True, text=True, timeout=timeout, cwd=work)
        if proc.returncode != 0:
            raise AssertionError(f"cli {' '.join(args[:2])} failed ({proc.returncode}):\n"
                                 f"{proc.stderr[-3000:]}")
        steps[f"{name}_s"] = time.perf_counter() - t0
        with open(command[3]) as fh:
            return proc.stdout, json.load(fh)["launches"]

    def info_verbs() -> dict:
        """status, version and template list, one after another."""
        return {name: run(name, *args)[0] for name, args in (
            ("status", ("status",)), ("version", ("version",)), ("template_list", ("template", "list")))}

    variant = rest["variant"]
    iterations = variant["algorithms"][0]["params"]["numIterations"]
    engine_dir = os.path.join(work, "engine")
    os.makedirs(engine_dir)
    with open(os.path.join(engine_dir, "engine.json"), "w") as fh:
        json.dump(variant, fh)
    try:
        # batchpredict --from-events --to-events
        out = os.path.join(work, "users.jsonl")
        run("batchpredict", "batchpredict", "--engine-dir", engine_dir, "--device", device,
            "--from-events", "--to-events", "--output", out)
        with open(out) as fh:
            lines = [json.loads(line) for line in fh]
        users = rest["user_ids"]
        written = list(LEventStore(smoke_storage(home)).find(
            app_name="restapp", event_names=["batchpredict.result"]))
        if len(lines) != len(users) or sorted(e.entity_id for e in written) != users:
            raise AssertionError(f"batchpredict: {len(lines)} lines, {len(written)} write-back "
                                 f"events for {len(users)} users")
        full = sum(len(r["itemScores"]) == 10 for r in lines)
        if full != len(users) - 1:  # every rater; the +08:00 event's viewer has no rating
            raise AssertionError(f"batchpredict: {full} users with 10 items")
        # deploy, then undeploy: the server exits 0 within 10 s; beside them
        # the info verbs
        info_pool = concurrent.futures.ThreadPoolExecutor(1)
        info = info_pool.submit(info_verbs)
        info_pool.shutdown(wait=False)
        port = _free_port()
        deploy = subprocess.Popen(
            argv("deploy", "--engine-dir", engine_dir, "--device", device,
                 "--ip", "127.0.0.1", "--port", str(port)),
            env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL, cwd=work)
        try:
            t0 = time.perf_counter()
            while True:
                if deploy.poll() is not None:
                    raise AssertionError(f"deploy exited {deploy.returncode}")
                try:
                    if _http(f"http://127.0.0.1:{port}/", timeout=2)[0] == 200:
                        break
                except (urllib.error.URLError, ConnectionError, TimeoutError):
                    pass
                if time.perf_counter() - t0 > 180:
                    raise AssertionError("deploy did not answer GET / within 180 s")
                time.sleep(0.2)
            stdout, _ = run("undeploy", "undeploy", "--ip", "127.0.0.1", "--port", str(port))
            t0 = time.perf_counter()
            if json.loads(stdout) != {"message": "Stopping."}:
                raise AssertionError(f"undeploy answered {stdout!r}")
            code = deploy.wait(timeout=10)
            steps["undeploy_exit_s"] = time.perf_counter() - t0
            if code != 0:
                raise AssertionError(f"the undeployed server exited {code}")
        finally:
            if deploy.poll() is None:
                _stop(deploy)
        printed = info.result(timeout=600)
        if torch.cuda.get_device_name(0) not in printed["status"]:
            raise AssertionError(f"status does not name the card:\n{printed['status']}")
        if not printed["version"].strip():
            raise AssertionError("version printed nothing")
        if "recommendation" not in printed["template_list"].split():
            raise AssertionError(f"template list: {printed['template_list']}")

        # eval: the grid in-process, with 2 workers, then resumed
        grid_variant = {**variant, "datasource": {"params": {
            **variant["datasource"]["params"], "evalParams": {"kFold": EVAL_FOLDS, "queryNum": 10}}}}
        with open(os.path.join(work, "smoke_grid_eval.py"), "w") as fh:
            fh.write(_GRID_EVALUATION.format(variant=grid_variant))
        grid = ["eval", "smoke_grid_eval.make_evaluation", "--device", device]
        w0, w2 = os.path.join(work, "grid0"), os.path.join(work, "grid2")
        stdout, counts = run("eval_workers_0", *grid, "--workers", "0", "--workdir", w0,
                             "--out", os.path.join(work, "r0.json"))
        cells = 4 * EVAL_FOLDS
        expected = cells * 2 * iterations
        if counts.get("spd_cg") != expected:
            raise AssertionError(f"eval launched B1 {counts.get('spd_cg')} times, expected {expected}")
        run("eval_workers_2", *grid, "--workers", "2", "--workdir", w2,
            "--out", os.path.join(work, "r2.json"))
        run("eval_resume", *grid, "--workers", "0", "--workdir", w2, "--resume",
            "--out", os.path.join(work, "r3.json"))
        r0, r2, r3 = (json.load(open(os.path.join(work, f"r{i}.json"))) for i in (0, 2, 3))

        def cell_ids(workdir):
            with open(os.path.join(workdir, "ledger.jsonl")) as fh:
                return sorted(json.loads(line)["cellId"] for line in fh)

        if r0["cells_total"] != cells or r0["cells_run"] != cells or r0["cells_failed"]:
            raise AssertionError(f"eval --workers 0: {r0['cells_run']} of {r0['cells_total']} cells")
        if cell_ids(w0) != cell_ids(w2) or r2["cells_run"] != cells:
            raise AssertionError("eval --workers 2 scored other cells than --workers 0")
        # atomic sums in the Gram build make ALS differ at rounding between runs
        score_limit = 0.02
        diffs = [abs(a["score"] - b["score"]) for a, b in zip(r0["scores"], r2["scores"])]
        if not max(diffs) <= score_limit:
            raise AssertionError(f"eval: workers 0 and 2 differ by {diffs}")
        if r3["cells_run"] != 0 or r3["cells_skipped"] != cells:
            raise AssertionError(f"eval --resume retrained {r3['cells_run']} cells")
        if not all(0.0 < s["score"] < 1.0 for s in r0["scores"]):
            raise AssertionError(f"eval: precision@10 out of range {r0['scores']}")
        for path in reports:
            with open(path) as fh:
                foreign = json.load(fh)["foreign_modules"]
            if foreign:
                raise AssertionError(f"{os.path.basename(path)}: imported {foreign[:5]}")
    finally:
        remove_work(work)
    result = {
        "host_numbers": True, **steps,
        "batchpredict_lines": len(lines), "writeback_events": len(written),
        "eval_cells": r0["cells_total"], "eval_spd_cg_launches": counts["spd_cg"],
        "precision_at_10": {f"rank {10 if i < 2 else 20}, lambda {(0.01, 0.1)[i % 2]}":
                            [s["score"] for s in (r0["scores"][i], r2["scores"][i])]
                            for i in range(4)},
        "max_score_diff_workers_0_2": max(diffs), "score_limit": score_limit,
        "eval_cells_per_s": cells / r0["wall_s"], "eval_wall_s_workers_0_2": [r0["wall_s"], r2["wall_s"]],
        "resume_cells_run": r3["cells_run"],
    }
    emit(phase="offline_cli", **result)
    return {"launches": {"eval": counts["spd_cg"]}}


# the eval grid's folds (cut from 3 to 2 to fit the script's time)
EVAL_FOLDS = 2


@phase
def eval_b1_rows(torch, home: str) -> list[dict]:
    """B1 on the systems of an eval cell at rank 20 (fold 0 of the grid's
    read_eval, lambda 0.1), trained in-process, each row held to the plain
    version and timed."""
    from predictionio_tpu_torch.models.recommendation import engine as rec
    from predictionio_tpu_torch.ops.spd_solve import batched_spd_solve_fused
    from predictionio_tpu_torch.workflow.context import WorkflowContext

    ctx = WorkflowContext(mode="evaluation", device="cuda", _storage=smoke_storage(home))
    ds = rec.DataSource(rec.DataSourceParams(app_name="restapp",
                                             eval_params=rec.EvalParams(k_fold=EVAL_FOLDS)))
    td, _, _ = ds.read_eval(ctx)[0]
    params = rec.ALSAlgorithmParams(rank=20, num_iterations=10, lambda_=0.1, seed=3)
    batched_spd_solve_fused.launches = 0
    model = rec.ALSAlgorithm(params).train(ctx, td)
    rows, _ = real_system_check(torch, td, model, params, batched_spd_solve_fused.launches,
                                row_rel_limit=1e-4, label="eval cell, rank 20, fold 0",
                                synthetic=False)
    return rows


REC_FACTORY = "predictionio_tpu_torch.models.recommendation.engine.engine_factory"
STREAM_ENGINE = "smoke-stream"


def _p50_ms(values) -> float:
    return float(np.percentile(np.asarray(values, dtype=np.float64) * 1e3, 50))


def _query(base: str, payload, timeout: float = 30.0):
    """POST /queries.json: (status, body, the answering model version, seconds)."""
    req = urllib.request.Request(base + "/queries.json", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        body = json.loads(resp.read())
        return resp.status, body, resp.headers.get("X-Pio-Model-Version"), time.perf_counter() - t0


def _rating_events(model, rng, existing: np.ndarray, new_ids: list, new_taste: np.ndarray,
                   n_new: int, t_start):
    """Rate events around a trained ALS model's own scores (plus noise 0.3,
    half stars in 1..5) on zipf-popular items: one per entry of
    ``existing`` (user indices), then ``n_new`` by the users of ``new_ids``,
    each rating as the existing user ``new_taste[j]`` would; shuffled, one
    millisecond apart from ``t_start``."""
    import datetime as dt

    from predictionio_tpu_torch.data.event import Event

    n_items = len(model.item_vocab)
    new = rng.integers(0, len(new_ids), n_new)
    src = np.concatenate([existing, new_taste[new]])
    ids = [model.user_vocab[u] for u in existing] + [new_ids[j] for j in new]
    items = (rng.zipf(1.3, len(src)) % n_items).astype(np.int64)
    raw = np.sum(model.user_factors[src] * model.item_factors[items], axis=1)
    ratings = np.clip(np.round(2 * (raw + 0.3 * rng.normal(size=len(src)))) / 2, 1.0, 5.0)
    out = []
    for n, k in enumerate(rng.permutation(len(src)).tolist()):
        t = t_start + dt.timedelta(milliseconds=n)
        out.append(Event(event="rate", entity_type="user", entity_id=ids[k], target_entity_type="item",
                         target_entity_id=model.item_vocab[items[k]],
                         properties={"rating": float(ratings[k])}, event_time=t, creation_time=t,
                         event_id=f"s{n:07d}"))
    return out


@phase
def stream_foldin_phase(torch, home: str, model, n_active: int = 3_750, n_existing: int = 75_000,
                        n_new_users: int = 2_500, n_new: int = 25_000, batch_limit: int = 500,
                        publish_min_events: int = 25_000, sampled_users: int = 1_000) -> dict:
    """The speed layer in-process at full width: the ML-20M model of the
    train phase published as stable into an ArtifactStore; 100,000 rate
    events from a fixed seed written into a sqlite event store (75,000 by
    3,750 active existing users on existing items, 20 each, and 25,000 by
    2,500 new users, 10 each, every rating around the model's own score);
    EventTailer(batch_limit=500) -> FoldInALSTrainer on the card ->
    StreamPipeline(publish_min_events=25,000, canary 0.1): 200 absorbs, two
    B1 launches each (the touched users against the fixed items, then the
    touched items against the updated users), 4 published candidates.
    Every launch's x is held to the plain version on the same A and b by
    b1_rows_held's rule at row-relative 1e-4, 1,000 folded users to a
    float64 solve of their normal equations (row-relative 1e-3); the drift
    guard is ok at every publish and the new users have factors. The stable
    pins an ANN index (AnnConfig(min_items=0)), so every candidate publish
    refreshes it (ann.lifecycle.refresh_for_publish): each candidate's
    manifest pins its own index, and errors{stage="ann"} stays 0."""
    import datetime as dt

    from predictionio_tpu_torch.ann import AnnConfig
    from predictionio_tpu_torch.ann import lifecycle as ann_lifecycle
    from predictionio_tpu_torch.data.storage.base import App
    from predictionio_tpu_torch.ops.spd_solve import batched_spd_solve_fused
    from predictionio_tpu_torch.registry import ArtifactStore, ModelManifest
    from predictionio_tpu_torch.stream import (CursorStore, EventTailer, StreamConfig,
                                               StreamPipeline, trainer_for_models)
    from predictionio_tpu_torch.stream.trainers import FOLD_PARTS
    from predictionio_tpu_torch.workflow import model_io

    work = os.path.join(home, "stream")
    storage = smoke_storage(work)
    app_id = storage.get_meta_data_apps().insert(App(0, "streamapp"))
    levents = storage.get_l_events()
    levents.init(app_id)
    store = ArtifactStore(os.path.join(work, "registry"))
    t0 = time.perf_counter()
    stable_blob = model_io.serialize_models([model])
    store.publish(ModelManifest(version="", engine_id=STREAM_ENGINE, engine_version="1",
                                engine_variant="engine.json", engine_factory=REC_FACTORY), stable_blob)
    stable_publish_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    stable_index = ann_lifecycle.build_for_version(store, STREAM_ENGINE, "v000001", [model],
                                                   AnnConfig(min_items=0), device="cuda")
    stable_index_s = time.perf_counter() - t0
    if not stable_index:
        raise AssertionError("no ANN index was pinned on the fold-in's stable")
    rng = np.random.default_rng(31)
    n_users = len(model.user_vocab)
    active = rng.choice(n_users, n_active, replace=False)
    new_ids = [f"new{j}" for j in range(n_new_users)]
    events = _rating_events(model, rng, active[rng.integers(0, n_active, n_existing)], new_ids,
                            rng.integers(0, n_users, n_new_users), n_new,
                            dt.datetime.now(tz=dt.timezone.utc) - dt.timedelta(days=1))
    t0 = time.perf_counter()
    for lo in range(0, len(events), 10_000):
        levents.insert_batch(events[lo:lo + 10_000], app_id)
    write_s = time.perf_counter() - t0
    n_total = len(events)
    seen_new = {e.entity_id for e in events if e.entity_id.startswith("new")}
    del events

    trainer = trainer_for_models([model], device="cuda")
    parts: list[dict] = []
    absorb = trainer.absorb

    def timed_absorb(batch):
        n = absorb(batch)
        parts.append(dict(trainer.last_absorb_stats))
        return n

    trainer.absorb = timed_absorb
    held = {"user": [], "item": []}
    refined = {"user": [], "item": []}  # B1 against float64 where f32 CG converged
    sizes = {"user": [], "item": []}
    f64 = []
    systems = {}
    # users held to float64 in each absorb: sampled_users over the run
    per_absorb = -(-sampled_users * batch_limit // n_total)

    def hold(side, order, A, b, x):
        record = b1_held(torch, A, b, 1e-4, f"a fold-in's {side} side", x=x)
        held[side].append(record["max_row_rel_err"])
        refined[side].append(record["refined"]["kernel_max_f64_row_err_converged"])
        sizes[side].append(len(order))
        if len(parts) == 10 and side not in systems:  # an absorb of the steady state
            systems[side] = (A.clone(), b.clone())
        if side == "user" and len(f64) < sampled_users:
            fixed = trainer.item_factors  # the table this solve ran against
            xs = x.cpu().numpy()
            for k in range(0, len(order), max(1, len(order) // per_absorb))[:per_absorb]:
                pairs = trainer._user_ratings[order[k]]
                V = fixed[np.fromiter((p[0] for p in pairs), np.int64, len(pairs))].astype(np.float64)
                r = np.fromiter((p[1] for p in pairs), np.float64, len(pairs))
                exact = np.linalg.solve(V.T @ V + trainer.reg * max(1.0, len(pairs)) * np.eye(V.shape[1]),
                                        V.T @ r)
                f64.append(float(np.linalg.norm(xs[k] - exact) / np.linalg.norm(exact)))

    trainer.solve_hook = hold
    pipeline = StreamPipeline(
        EventTailer(levents, app_id, batch_limit=batch_limit), trainer,
        CursorStore(os.path.join(work, "cursors")), store,
        StreamConfig(engine_id=STREAM_ENGINE, engine_version="1", engine_variant="engine.json",
                     engine_factory=REC_FACTORY, mode="canary", fraction=0.1,
                     publish_min_events=publish_min_events,
                     max_batches_per_cycle=publish_min_events // batch_limit,
                     keep_versions=20))
    batched_spd_solve_fused.launches = 0
    t0 = time.perf_counter()
    summaries = []
    while True:
        summaries.append(pipeline.run_once())
        if summaries[-1]["drained"] == 0:
            break
    wall_s = time.perf_counter() - t0
    launches = batched_spd_solve_fused.launches
    published = [s["published"] for s in summaries if s["published"]]
    drained = sum(s["drained"] for s in summaries)
    absorbs = -(-n_total // batch_limit)
    if drained != n_total or len(parts) != absorbs:
        raise AssertionError(f"fold-in drained {drained} of {n_total} events in {len(parts)} absorbs")
    if any(s["driftSuppressed"] for s in summaries) or not trainer.drift().ok:
        raise AssertionError(f"the drift guard breached: {trainer.drift()}")
    if len(published) != n_total // publish_min_events:
        raise AssertionError(f"fold-in published {published}")
    if launches != 2 * absorbs:
        raise AssertionError(f"fold-in launched B1 {launches} times for {absorbs} absorbs")
    if len(f64) < sampled_users or max(f64) > 1e-3:
        raise AssertionError(f"{len(f64)} folded users, largest row error {max(f64)} from float64")
    # a new user whose every event the drift guard held out is never folded
    folded_new = [trainer._user_index[u] for u in sorted(seen_new) if u in trainer._user_index]
    new_norm = np.linalg.norm(trainer.user_factors[folded_new], axis=1)
    if len(folded_new) < 0.99 * len(seen_new) or not (np.isfinite(new_norm).all() and (new_norm > 0).all()):
        raise AssertionError(f"{len(folded_new)} of {len(seen_new)} new users folded, or one has no factors")
    state = store.get_state(STREAM_ENGINE)
    if (state.stable, state.candidate, state.mode, state.fraction) != ("v000001", published[-1], "canary", 0.1):
        raise AssertionError(f"registry state after the stream: {state.to_json_dict()}")
    refreshes = list(pipeline.ann_refreshes)
    pinned = {v: (store.get_manifest(STREAM_ENGINE, v).ann_index or {}) for v in published}
    ann_errors = pipeline.instruments.errors.value(stage="ann")
    if ann_errors or [r["version"] for r in refreshes] != published or any(
            m.get("modelVersion") != v or m.get("builtFrom") not in ("refresh", "rebuild")
            or store.load_ann_blob(STREAM_ENGINE, v) is None for v, m in pinned.items()):
        raise AssertionError(f"ANN refreshes {refreshes}, errors {ann_errors}, candidates' indexes {pinned}")
    kernel_rows = []
    for side in ("user", "item"):
        A, b = systems[side]
        kernel_rows.append({"systems": f"stream fold-in, ML-20M {side}s of one absorb",
                            **b1_held(torch, A, b, 1e-4, f"the timed fold-in {side} side"),
                            **b1_times(torch, A, b)})
        emit(phase="kernel_real", kernel="spd_cg", **kernel_rows[-1])
    publish = [{k: v for k, v in p.items()} for p in pipeline.publish_seconds]
    result = {
        "host_numbers": True, "events": n_total, "active_users": n_active, "new_users": len(seen_new),
        "new_users_folded": len(folded_new),
        "write_events_per_s": n_total / write_s, "stable_publish_s": stable_publish_s,
        "foldin_wall_s": wall_s, "foldin_events_per_s": n_total / wall_s, "absorbs": len(parts),
        "absorb_p50_ms": {k: _p50_ms([p[k] for p in parts]) for k in FOLD_PARTS},
        "systems_per_solve_p50": {k: float(np.percentile(v, 50)) for k, v in sizes.items()},
        "publish_s": publish, "published": published, "spd_cg_launches": launches,
        "held_max_row_rel_err": {k: max(v) for k, v in held.items()},
        "refined_max_f64_row_err_converged": {k: max(v) for k, v in refined.items()},
        "float64_users": len(f64), "float64_max_row_err": max(f64),
        "drift": trainer.drift().to_json_dict(),
        "ann_stable_index": {"seconds": stable_index_s, **stable_index},
        "ann_refreshes": refreshes,
        "ann_errors": ann_errors,
    }
    emit(phase="stream_foldin", shape=[n_users, len(model.item_vocab), 32], **result)
    return {"launches": {"stream_foldin": launches}, "rows": kernel_rows, "store": store,
            "storage": storage, "work": work, "published": published, "stable_blob": stable_blob}


def _engine_dir(path: str, engine_id: str, app_name: str, params: dict) -> str:
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "engine.json"), "w") as fh:
        json.dump({"id": engine_id, "engineFactory": REC_FACTORY,
                   "datasource": {"params": {"appName": app_name}},
                   "algorithms": [{"name": "als", "params": params}]}, fh)
    return path


def _lane_answers_held(server, lane, outs, users, what: str) -> None:
    """Every answer equal to ServingIndex.serve_batch of that lane's own
    model (tie-aware, rtol 1e-5)."""
    model = lane.models[0]
    got_ids = np.asarray([[model.item_index(x["item"]) for x in body["itemScores"]] for _, body, _, _ in outs])
    got_scores = np.asarray([[x["score"] for x in body["itemScores"]] for _, body, _, _ in outs])
    uidx = np.asarray([model.user_index(u) for u in users], dtype=np.int32)
    ref_scores, ref_ids = model.serving_index().serve_batch(uidx, 20)
    _same_topk(got_ids, got_scores, ref_ids, ref_scores, 1e-5, what)


@phase
def rollout_lanes_phase(torch, home: str, foldin: dict, n_queries: int = 1_000) -> dict:
    """A QueryServer on the card deployed from the fold-in's registry with
    registry sync every 0.5 s. Canary: it adopts the staged candidate, and
    1,000 queries for 1,000 distinct users route by sticky_bucket(user,
    salt = candidate version) with a candidate share within 0.1 +- 0.03,
    every answer equal to serve_batch of its lane's own model. POST
    /models/promote: every answer from the candidate. Staging the next
    candidate then POST /models/rollback: stable unchanged. Shadow: answers
    only from stable, divergence recorded. Five stage/promote cycles:
    torch.cuda.memory_allocated within 10 % of its value after the first.
    POST /reload last: the latest COMPLETED instance swaps in."""
    import datetime as dt
    import gc

    from predictionio_tpu_torch.ann import lifecycle as ann_lifecycle
    from predictionio_tpu_torch.data.storage.base import EngineInstance, EngineInstanceStatus, Model
    from predictionio_tpu_torch.registry import sticky_bucket
    from predictionio_tpu_torch.workflow.context import WorkflowContext
    from predictionio_tpu_torch.workflow.create_server import ServerConfig, create_query_server

    storage, store, published = foldin["storage"], foldin["store"], foldin["published"]
    params = {"rank": 32}
    engine_dir = _engine_dir(os.path.join(foldin["work"], "engine"), STREAM_ENGINE, "streamapp", params)
    now = dt.datetime.now(tz=dt.timezone.utc)
    instance_id = storage.get_meta_data_engine_instances().insert(EngineInstance(
        id="", status=EngineInstanceStatus.COMPLETED, start_time=now, end_time=now,
        engine_id=STREAM_ENGINE, engine_version="1", engine_variant="engine.json",
        engine_factory=REC_FACTORY, data_source_params=json.dumps({"appName": "streamapp"}),
        algorithms_params=json.dumps([{"name": "als", "params": params}])))
    storage.get_model_data_models().insert(Model(instance_id, foldin["stable_blob"]))
    ctx = WorkflowContext(mode="serving", device="cuda", _storage=storage)
    config = ServerConfig(ip="127.0.0.1", port=0, registry_dir=store.base_dir,
                          registry_sync_interval_s=0.5, bake_window_s=3600.0)
    t0 = time.perf_counter()
    server = create_query_server(engine_dir, ctx, config)
    deploy_s = time.perf_counter() - t0
    base = f"http://127.0.0.1:{server.start()}"
    users = [f"u{i}" for i in range(n_queries)]
    steps = {"deploy_s": deploy_s}

    def queries(us, workers=16):
        with concurrent.futures.ThreadPoolExecutor(workers) as pool:
            outs = list(pool.map(lambda u: _query(base, {"user": u, "num": 10}), us))
        if any(status != 200 for status, _, _, _ in outs):
            raise AssertionError("a query was not answered 200")
        return outs

    def post(path, payload=None):
        t = time.perf_counter()
        status, body, _ = _http(base + path, payload if payload is not None else {})
        if status != 200:
            raise AssertionError(f"POST {path} answered {status}: {body}")
        return body, time.perf_counter() - t

    try:
        cand = published[-1]
        t0 = time.perf_counter()
        while server._candidate is None or server._candidate.version != cand:
            if time.perf_counter() - t0 > 120:
                raise AssertionError(f"the server never adopted the staged candidate {cand}")
            time.sleep(0.05)
        steps["adopt_candidate_s"] = time.perf_counter() - t0
        stable, cand_lane, plan, _ = server.lanes()
        for lane in (stable, cand_lane):
            attached = getattr(lane.models[0], ann_lifecycle.ATTR, None)
            if attached is None or attached.index.model_version != lane.version:
                raise AssertionError(f"lane {lane.version} loaded without its ANN index")
        steps["ann_indexes_attached"] = [stable.version, cand_lane.version]
        outs = queries(users)
        lanes = [v for _, _, v, _ in outs]
        want = [cand if sticky_bucket(u, cand) < plan.fraction else stable.version for u in users]
        if lanes != want:
            bad = next(i for i, (a, b) in enumerate(zip(lanes, want)) if a != b)
            raise AssertionError(f"{users[bad]} answered by {lanes[bad]}, its bucket says {want[bad]}")
        share = lanes.count(cand) / len(lanes)
        if abs(share - 0.1) > 0.03:
            raise AssertionError(f"candidate share {share} outside 0.1 +- 0.03")
        for lane in (stable, cand_lane):
            pick = [i for i, v in enumerate(lanes) if v == lane.version]
            _lane_answers_held(server, lane, [outs[i] for i in pick], [users[i] for i in pick],
                               f"canary answers of {lane.version}")
        canary_p50 = _p50_ms([dt_s for _, _, _, dt_s in outs])

        body, _ = post("/models/promote")
        if body["version"] != cand or store.get_state(STREAM_ENGINE).stable != cand:
            raise AssertionError(f"promote: {body}")
        outs = queries(users[:500])
        if {v for _, _, v, _ in outs} != {cand}:
            raise AssertionError("after promote an answer came from another lane")
        _lane_answers_held(server, server._active, outs, users[:500], "answers after promote")
        stable_p50 = _p50_ms([dt_s for _, _, _, dt_s in outs])

        nxt = published[-2]
        _, steps["lane_load_s"] = post("/models/candidate", {"version": nxt, "fraction": 0.5})
        body, _ = post("/models/rollback")
        state = store.get_state(STREAM_ENGINE)
        if body["version"] != nxt or state.stable != cand or state.candidate:
            raise AssertionError(f"rollback: {body} {state.to_json_dict()}")
        if {v for _, _, v, _ in queries(users[:200])} != {cand}:
            raise AssertionError("after rollback an answer came from another lane")

        post("/models/candidate", {"version": published[0], "mode": "shadow"})
        inst = server._rollout_instruments
        outs = queries(users[:300], workers=4)
        if {v for _, _, v, _ in outs} != {cand}:
            raise AssertionError("a shadow candidate answered a query")
        t0 = time.perf_counter()
        while inst.shadow_scored.value(version=published[0]) + inst.shadow_dropped.value(version=published[0]) < 300:
            if time.perf_counter() - t0 > 120:
                raise AssertionError("shadow scoring never caught up")
            time.sleep(0.05)
        shadow = {"scored": inst.shadow_scored.value(version=published[0]),
                  "dropped": inst.shadow_dropped.value(version=published[0]),
                  "diverged": inst.divergence.value(version=published[0]),
                  "errors": inst.errors.value(version=published[0], lane="shadow")}
        if shadow["scored"] == 0 or shadow["errors"]:
            raise AssertionError(f"shadow: {shadow}")
        post("/models/rollback")

        memory = []
        for cycle in range(5):
            current = server.model_version
            version = next(v for v in reversed(published) if v != current)
            post("/models/candidate", {"version": version, "fraction": 0.5})
            queries(users[:64], workers=8)
            post("/models/promote")
            gc.collect()
            torch.cuda.synchronize()
            memory.append(torch.cuda.memory_allocated())
        if memory[-1] > 1.1 * memory[0]:
            raise AssertionError(f"card memory grew across lane swaps: {memory}")

        # the sync must have seen the last promote first: a registry stable
        # it had yet to reconcile would otherwise replace the reloaded lane
        t0 = time.perf_counter()
        while server._seen_state_gen != store.state_generation(STREAM_ENGINE):
            if time.perf_counter() - t0 > 30:
                raise AssertionError("registry sync never caught up with the promotes")
            time.sleep(0.05)
        body, steps["reload_s"] = post("/reload")
        if body.get("instanceId") != instance_id or server.model_version != instance_id:
            raise AssertionError(f"/reload: {body}")
        outs = queries(users[:200])
        if {v for _, _, v, _ in outs} != {instance_id}:
            raise AssertionError("after /reload an answer came from another lane")
        _lane_answers_held(server, server._active, outs, users[:200], "answers after /reload")
    finally:
        server.shutdown()
    result = {"host_numbers": True, **steps, "queries_canary": n_queries, "candidate_share": share,
              "canary_query_p50_ms": canary_p50, "stable_query_p50_ms": stable_p50,
              "shadow": shadow, "memory_allocated_after_cycles": memory,
              "promotions": inst.promotions.value(),
              "rollbacks": inst.rollbacks.value(reason="manual")}
    emit(phase="rollout_lanes", **result)
    return result


# ---------------------------------------------------------------------------
# the query server's serving contract
# ---------------------------------------------------------------------------


def _make_cert(work: str) -> tuple[str, str]:
    """A self-signed certificate for 127.0.0.1 from openssl, as
    tests/test_torch_event_server.py makes one; no openssl fails the phase."""
    cert, key = os.path.join(work, "cert.pem"), os.path.join(work, "key.pem")
    subprocess.run(["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes", "-days", "1",
                    "-subj", "/CN=127.0.0.1", "-keyout", key, "-out", cert],
                   check=True, capture_output=True, timeout=60)
    return cert, key


def _tls_context(cert: str):
    import ssl

    ctx = ssl.create_default_context(cafile=cert)
    ctx.check_hostname = False
    return ctx


class _Conn:
    """A keep-alive client of one server, HTTPS when given a context:
    ``call`` returns (status, Retry-After, decoded body, seconds)."""

    def __init__(self, port: int, tls=None, timeout: float = 30.0):
        import http.client

        self.conn = (http.client.HTTPSConnection("127.0.0.1", port, context=tls, timeout=timeout)
                     if tls is not None else http.client.HTTPConnection("127.0.0.1", port, timeout=timeout))

    def call(self, method: str, path: str, payload=None, headers=None):
        t0 = time.perf_counter()
        data = None if payload is None else json.dumps(payload).encode()
        self.conn.request(method, path, body=data, headers={"Content-Type": "application/json", **(headers or {})})
        resp = self.conn.getresponse()
        body = json.loads(resp.read())
        return resp.status, resp.getheader("Retry-After"), body, time.perf_counter() - t0

    def close(self) -> None:
        self.conn.close()


def _one_call(port: int, tls, method: str, path: str, payload=None, headers=None, timeout: float = 30.0):
    conn = _Conn(port, tls, timeout)
    try:
        return conn.call(method, path, payload, headers)
    finally:
        conn.close()


class _Collector:
    """A plain HTTP server in this process recording every POST body: the
    remote-log collector."""

    def __init__(self):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self.bodies: list[bytes] = []
        bodies = self.bodies

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):
                pass

            def do_POST(self):
                bodies.append(self.rfile.read(int(self.headers.get("Content-Length") or 0)))
                self.send_response(200)
                self.send_header("Content-Length", "0")
                self.end_headers()

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.httpd.daemon_threads = True
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}/log"
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(10)


def _wait(pred, timeout: float, what: str) -> float:
    t0 = time.perf_counter()
    while not pred():
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"{what}: not within {timeout} s")
        time.sleep(0.02)
    return time.perf_counter() - t0


@phase
def serving_contract_cli_phase(work: str, argv, reports: list, run, es_port: int, engine_dir: str,
                               users: list, n_items: int, train_launches: int, device: str = "cuda") -> int:
    """The serving contract through the CLI, on the event server's store
    while that event server is up, every verb a process of the launcher
    (no JAX, JAX package or aiohttp in any): ``pio deploy`` with every
    serving flag (TLS from an openssl certificate, an access key, feedback
    into the running event server, a remote log to a collector in this
    process, request timeout 2 s, queue high water 32, drain grace 5 s).
    100 queries over HTTPS with the key answer 200; without the key 401; a
    query that fails in serving 400, and exactly one remote-log body with
    the prefix arrives; the store then holds one predict event per answered
    query, with its query and the body answered; a silent TCP client does
    not delay an HTTPS query; SIGTERM amid a burst of 32: /healthz answers
    503 while draining, every accepted query 200, the process exits 0
    within the grace. Meanwhile ``pio train`` retrains through B1, and a
    second TLS deploy, started beside the first, stops through ``pio
    undeploy --ssl``. The retrain must launch B1 as often as the first
    train (``train_launches``); returns that count."""
    import socket as socket_mod

    cert, key = _make_cert(work)
    tls = _tls_context(cert)
    collector = _Collector()
    steps = {}
    env = {**os.environ, "PYTHONPATH": os.path.dirname(os.path.abspath(__file__))}
    # the retrain runs beside the first deploy's checks
    retrain = subprocess.Popen(argv("train", "--engine-dir", engine_dir, "--device", device),
                               env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    retrain_report = reports[-1]
    out, _ = run("app", "new", "feedbackapp")
    fb_key = next(ln.split(":", 1)[1].strip() for ln in out.splitlines() if ln.startswith("Access Key:"))
    qkey = "smoke-query-key"
    prefix = "SMOKE-LOG "

    def deploy(name, *flags):
        port = _free_port()
        err = open(os.path.join(work, f"{name}.err"), "w")
        proc = subprocess.Popen(
            argv("deploy", "--engine-dir", engine_dir, "--device", device, "--ip", "127.0.0.1",
                 "--port", str(port), "--ssl-certfile", cert, "--ssl-keyfile", key, *flags),
            env=env, stdout=subprocess.DEVNULL, stderr=err)
        err.close()
        return name, proc, port, time.perf_counter()

    def ready(name, proc, port, t0):
        while True:
            if proc.poll() is not None:
                with open(os.path.join(work, f"{name}.err")) as fh:
                    raise AssertionError(f"{name} exited {proc.returncode}: {fh.read()}")
            try:
                if _one_call(port, tls, "GET", "/healthz", timeout=2)[0] == 200:
                    return proc, port, time.perf_counter() - t0
            except OSError:
                pass
            if time.perf_counter() - t0 > 180:
                _stop(proc)
                raise AssertionError(f"{name} did not answer GET /healthz over HTTPS within 180 s")
            time.sleep(0.2)

    first = deploy(
        "contract_deploy", "--accesskey", qkey, "--feedback",
        "--event-server-url", f"http://127.0.0.1:{es_port}", "--feedback-access-key", fb_key,
        "--log-url", collector.url, "--log-prefix", prefix, "--request-timeout", "2",
        "--queue-high-water", "32", "--drain-grace", "5")
    second = deploy("undeploy_target")
    proc, proc2 = first[1], second[1]
    qpath = f"/queries.json?accessKey={qkey}"
    passed = False
    try:
        _, port, steps["deploy_ready_s"] = ready(*first)
        local = threading.local()

        def query(u):
            if not hasattr(local, "conn"):
                local.conn = _Conn(port, tls)
            return local.conn.call("POST", qpath, {"user": u, "num": 10})

        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            answers = list(pool.map(query, users[:100]))
        https_wall = time.perf_counter() - t0
        for status, _, body, _ in answers:
            if status != 200:
                raise AssertionError(f"an HTTPS query with the key answered {status}: {body}")
            _check_result(body, 10, n_items)
        status, _, body, _ = _one_call(port, tls, "POST", "/queries.json", {"user": users[0]})
        if (status, body) != (401, {"message": "Invalid accessKey."}):
            raise AssertionError(f"a query without the key answered {status} {body}")
        status, _, body, _ = _one_call(port, tls, "POST", qpath, {"num": 3})
        if (status, body) != (400, {"message": "'user'"}):
            raise AssertionError(f"a query that fails in serving answered {status} {body}")
        steps["remote_log_s"] = _wait(lambda: collector.bodies, 10, "the remote log")
        time.sleep(0.5)
        if len(collector.bodies) != 1 or not collector.bodies[0].startswith(prefix.encode()):
            raise AssertionError(f"remote log: {len(collector.bodies)} bodies, {collector.bodies[:1]}")
        logged = json.loads(collector.bodies[0][len(prefix):])
        if not (logged["message"].startswith("Query:\n{'num': 3}\n\nStack Trace:\n")
                and "KeyError: 'user'" in logged["message"]):
            raise AssertionError(f"remote log body: {logged}")

        es = _Conn(es_port)

        def landed():
            status, _, events, _ = es.call("GET", f"/events.json?accessKey={fb_key}&event=predict&limit=-1")
            return events if status == 200 else []

        steps["feedback_landed_s"] = _wait(lambda: len(landed()) >= len(answers), 60, "the predict events")
        events = landed()
        es.close()
        want = {u: body for u, (_, _, body, _) in zip(users[:100], answers)}
        got = {e["properties"]["query"]["user"]: e for e in events}
        if len(events) != len(answers) or set(got) != set(want):
            raise AssertionError(f"{len(events)} predict events for {len(answers)} answered queries")
        for u, e in got.items():
            if (e["entityType"], e["entityId"]) != ("pio_pr", "smoke-rest") or \
                    e["properties"] != {"query": {"user": u, "num": 10}, "prediction": want[u]}:
                raise AssertionError(f"predict event of {u}: {e}")

        with socket_mod.create_connection(("127.0.0.1", port), timeout=5):  # sends no ClientHello
            status, _, _, silent_s = _one_call(port, tls, "POST", qpath, {"user": users[1]}, timeout=5)
        if status != 200 or silent_s > 1.0:
            raise AssertionError(f"beside a silent client an HTTPS query took {silent_s} s ({status})")

        # SIGTERM amid a burst: a query held in flight (its body half sent)
        # keeps the drain open while /healthz is read on a keep-alive connection
        health = _Conn(port, tls)
        if health.call("GET", "/healthz")[0] != 200:
            raise AssertionError("/healthz not ready before SIGTERM")
        body = json.dumps({"user": users[2], "num": 10}).encode()
        hold = tls.wrap_socket(socket_mod.create_connection(("127.0.0.1", port), timeout=10),
                               server_hostname="127.0.0.1")
        hold.sendall((f"POST {qpath} HTTP/1.1\r\nHost: 127.0.0.1\r\nContent-Type: application/json\r\n"
                      f"Content-Length: {len(body)}\r\n\r\n").encode() + body[:5])
        time.sleep(0.2)  # the server has read the headers: the query is in flight

        def burst_one(u):
            conn = _Conn(port, tls, timeout=10)
            try:
                conn.conn.connect()
            except OSError:
                return "refused"
            try:
                return conn.call("POST", qpath, {"user": u, "num": 10})[0]
            finally:
                conn.close()

        with concurrent.futures.ThreadPoolExecutor(32) as pool:
            burst = [pool.submit(burst_one, u) for u in users[:32]]
            time.sleep(0.01)
            t_term = time.perf_counter()
            proc.send_signal(signal.SIGTERM)
            outcomes = [f.result(timeout=30) for f in burst]
        draining = health.call("GET", "/healthz")
        health.close()
        hold.sendall(body[5:])
        held = hold.recv(65536).decode()
        hold.close()
        code = proc.wait(timeout=10)
        steps["sigterm_exit_s"] = time.perf_counter() - t_term
        if draining[0] != 503 or draining[2].get("draining") is not True:
            raise AssertionError(f"/healthz while draining: {draining[:3]}")
        if not held.startswith("HTTP/1.1 200"):
            raise AssertionError(f"the held query answered {held[:60]!r}")
        if set(outcomes) - {200, "refused"}:
            raise AssertionError(f"burst outcomes during the drain: {outcomes}")
        if code != 0 or steps["sigterm_exit_s"] > 5.0:
            raise AssertionError(f"deploy exited {code} {steps['sigterm_exit_s']} s after SIGTERM")
        burst_answered = outcomes.count(200)
        _, port2, _ = ready(*second)
        status, _, body, _ = _one_call(port2, tls, "POST", "/queries.json", {"user": users[3], "num": 10})
        if status != 200:
            raise AssertionError(f"the second deploy answered {status}")
        _check_result(body, 10, n_items)
        run("undeploy", "--ip", "127.0.0.1", "--port", str(port2), "--ssl")
        if proc2.wait(timeout=10) != 0:
            raise AssertionError(f"the undeployed server exited {proc2.returncode}")
        passed = True
    finally:
        for p in (proc, proc2) if passed else (proc, proc2, retrain):
            if p.poll() is None:
                _stop(p)
        collector.close()
    if retrain.wait(timeout=600) != 0:
        raise AssertionError(f"cli train failed ({retrain.returncode}):\n{retrain.stderr.read()}")
    with open(retrain_report) as fh:
        retrain_launches = json.load(fh)["launches"]["spd_cg"]
    if retrain_launches != train_launches:
        raise AssertionError(f"the retrain launched B1 {retrain_launches} times, the train {train_launches}")
    q_ms = np.asarray([dt_s for _, _, _, dt_s in answers]) * 1e3
    result = {
        "host_numbers": True, **steps,
        "https_queries": len(answers), "https_query_p50_ms": float(np.percentile(q_ms, 50)),
        "https_qps": len(answers) / https_wall, "no_key_status": 401, "failing_query_status": 400,
        "remote_log_bodies": 1, "predict_events": len(events), "silent_client_query_s": silent_s,
        "burst_answered": burst_answered, "burst_refused": outcomes.count("refused"),
        "healthz_while_draining": draining[0], "retrain_spd_cg_launches": retrain_launches,
    }
    emit(phase="serving_contract_cli", **result)
    return retrain_launches


def _tensor_bytes(torch) -> int:
    """Card memory held by tensors. The cuBLAS workspaces are freed first:
    each cuBLAS handle keeps one (32 MiB on this card), and a thread that
    replaces a walked-away one may take a new handle; that scratch is not a
    batch's tensors, and the next product allocates it again."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()
    return torch.cuda.memory_allocated()


def _blocked_answer(scores, ids, vocab, banned: frozenset, keep: int):
    """What the smoke's output blocker leaves of serve_batch's top-k: the
    items not banned, the first ``keep``."""
    return [(vocab[int(i)], float(s)) for s, i in zip(scores, ids) if vocab[int(i)] not in banned][:keep]


@phase
def serving_contract_inprocess_phase(torch, foldin: dict, n_queries: int = 1_000, burst: int = 512) -> dict:
    """The serving contract at full width: the ML-20M model the fold-in
    published as stable (138,000 users x 27,000 items, rank 32) in a
    QueryServer on the card with TLS, an access key, feedback into an
    in-process event server on the fold-in's sqlite store, a remote log,
    an output blocker (drops banned items, keeps 5) and a sniffer,
    request_timeout_s 1, queue_high_water 64, breaker_threshold 2,
    breaker_recovery_s 1. 1,000 queries from 16 clients: every answer is
    serve_batch's after the blocker's rewrite, and the sniffer saw every
    one; the same queries on a server without any of it, for p50 and qps.
    predict_batch_dispatch hung through a FaultInjector: 503 with
    Retry-After within timeout + 0.5 s, watchdog trips counted, the breaker
    open and /healthz 503 ``open``; faults cleared: half-open, then closed,
    answers equal again. A burst of 512 concurrent queries: each shed one
    503 with Retry-After, every other 200 and equal, no 500 and no reset.
    Card memory held by tensors after the chaos within 10 % of before."""
    from predictionio_tpu_torch.data.api.event_server import EventServer, EventServerConfig
    from predictionio_tpu_torch.data.storage.base import AccessKey, App
    from predictionio_tpu_torch.models.recommendation import engine as rec
    from predictionio_tpu_torch.ops import spd_solve
    from predictionio_tpu_torch.resilience import FaultInjector
    from predictionio_tpu_torch.workflow import model_io, server_plugins as sp
    from predictionio_tpu_torch.workflow.context import WorkflowContext
    from predictionio_tpu_torch.workflow.create_server import QueryServer, ServerConfig
    from predictionio_tpu_torch.workflow.engine_loader import EngineManifest

    spd_solve.batched_spd_solve_fused.launches = 0
    storage = foldin["storage"]
    work = work_dir(prefix="pio_smoke_contract_")
    cert, key = _make_cert(work)
    tls = _tls_context(cert)
    engine = rec.engine_factory()
    ep = engine.engine_params_from_variant({"algorithms": [{"name": "als", "params": {"rank": 32}}]})
    ctx = WorkflowContext(mode="serving", device="cuda", _storage=storage)
    (model,) = engine.prepare_deploy(ctx, ep, model_io.deserialize_models(foldin["stable_blob"]))
    vocab = model.item_vocab
    banned = frozenset(vocab[i] for i in range(0, len(vocab), 3))
    sniffed: list[int] = []
    sniff_lock = threading.Lock()

    class DropBanned(sp.EngineServerPlugin):
        plugin_name = "drop-banned"
        plugin_type = sp.OUTPUT_BLOCKER

        def process(self, variant, query, prediction, context):
            kept = tuple(s for s in prediction.item_scores if s.item not in banned)[:5]
            return rec.PredictedResult(kept)

    class Count(sp.EngineServerPlugin):
        plugin_name = "count"

        def process(self, variant, query, prediction, context):
            with sniff_lock:
                sniffed.append(len(prediction.item_scores))

    app_id = storage.get_meta_data_apps().insert(App(0, "contractapp"))
    fb_key = storage.get_meta_data_access_keys().insert(AccessKey("", app_id, ()))
    es = EventServer(storage=storage, config=EventServerConfig(ip="127.0.0.1", port=0))
    es_port = es.start()
    collector = _Collector()
    qkey = "smoke-query-key"
    manifest = EngineManifest("smoke-contract", "1", "engine.json", REC_FACTORY)
    on = QueryServer(engine, ep, [model], ctx, ServerConfig(
        ip="127.0.0.1", port=0, accesskey=qkey, feedback=True, event_server_url=f"http://127.0.0.1:{es_port}",
        feedback_access_key=fb_key, ssl_certfile=cert, ssl_keyfile=key, log_url=collector.url,
        log_prefix="SMOKE ", request_timeout_s=1.0, queue_high_water=64, breaker_threshold=2,
        breaker_recovery_s=1.0, result_cache_size=0), "contract-on", manifest=manifest,
        plugin_context=sp.EngineServerPluginContext([DropBanned(), Count()]))
    off = QueryServer(engine, ep, [model], ctx, ServerConfig(ip="127.0.0.1", port=0, result_cache_size=0),
                      "contract-off",
                      manifest=manifest, plugin_context=sp.EngineServerPluginContext([]))
    on_port, off_port = on.start(), off.start()
    qpath = f"/queries.json?accessKey={qkey}"
    users = [f"u{i}" for i in range(n_queries)]
    uidx = np.asarray([model.user_index(u) for u in users], dtype=np.int32)
    ref_scores, ref_ids = model.serving_index().serve_batch(uidx, 10)
    expected = {u: _blocked_answer(ref_scores[j], ref_ids[j], vocab, banned, 5) for j, u in enumerate(users)}

    def held(u, body, what):
        got = [(s["item"], s["score"]) for s in body["itemScores"]]
        want = expected[u]
        if [g[0] for g in got] != [w[0] for w in want] or not np.allclose(
                [g[1] for g in got], [w[1] for w in want], rtol=1e-5):
            raise AssertionError(f"{what}: {u} answered {got}, serve_batch after the blocker {want}")

    def drive(port, client_tls, path, us, clients=16):
        local = threading.local()

        def one(u):
            if not hasattr(local, "conn"):
                local.conn = _Conn(port, client_tls)
            return local.conn.call("POST", path, {"user": u, "num": 10})

        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(clients) as pool:
            outs = list(pool.map(one, us))
        return outs, time.perf_counter() - t0

    steps = {}
    answered_on = 0
    try:
        drive(on_port, tls, qpath, users[:64])  # warm both paths
        drive(off_port, None, "/queries.json", users[:64])
        answered_on += 64
        base = len(sniffed)
        outs_on, wall_on = drive(on_port, tls, qpath, users)
        for u, (status, _, body, _) in zip(users, outs_on):
            if status != 200:
                raise AssertionError(f"{u} answered {status} with the contract on: {body}")
            held(u, body, "contract on")
        answered_on += len(users)
        _wait(lambda: len(sniffed) - base >= n_queries, 30, "the sniffer")
        if len(sniffed) - base != n_queries:
            raise AssertionError(f"the sniffer saw {len(sniffed) - base} of {n_queries} answers")
        outs_off, wall_off = drive(off_port, None, "/queries.json", users)
        for u, (status, _, body, _) in zip(users, outs_off):
            if status != 200:
                raise AssertionError(f"{u} answered {status} with the contract off: {body}")
        # 20 reference columns: an item tied with the 10th at rounding may take its place
        wide_scores, wide_ids = model.serving_index().serve_batch(uidx, 20)
        _same_topk(np.asarray([[model.item_index(x["item"]) for x in b["itemScores"]] for _, _, b, _ in outs_off]),
                   np.asarray([[x["score"] for x in b["itemScores"]] for _, _, b, _ in outs_off]),
                   wide_ids, wide_scores, 1e-5, "answers with the contract off")
        on.config.feedback = False  # the same server, its feedback POSTs alone off
        outs_nofb, wall_nofb = drive(on_port, tls, qpath, users)
        on.config.feedback = True
        for u, (status, _, body, _) in zip(users, outs_nofb):
            if status != 200:
                raise AssertionError(f"{u} answered {status} with feedback off: {body}")
            held(u, body, "contract on, feedback off")
        steps.update(
            p50_on_ms=_p50_ms([o[3] for o in outs_on]), qps_on=n_queries / wall_on,
            p50_on_no_feedback_ms=_p50_ms([o[3] for o in outs_nofb]), qps_on_no_feedback=n_queries / wall_nofb,
            p50_off_ms=_p50_ms([o[3] for o in outs_off]), qps_off=n_queries / wall_off)

        mem_before = _tensor_bytes(torch)
        lane = on._active
        real = lane.algorithms[0]
        injector = FaultInjector(real)
        injector.inject("predict_batch_dispatch", latency_s=2.5)
        lane.algorithms[0] = injector
        chaos = []
        t_fault = time.perf_counter()
        for u in users[:2]:
            status, retry_after, body, dt_s = _one_call(on_port, tls, "POST", qpath, {"user": u, "num": 10})
            chaos.append((status, retry_after, body["message"], dt_s))
        steps["breaker_open_s"] = time.perf_counter() - t_fault
        status, retry_after, body, dt_s = _one_call(on_port, tls, "POST", qpath, {"user": users[2], "num": 10})
        chaos.append((status, retry_after, body["message"], dt_s))
        hz_status, _, hz, _ = _one_call(on_port, tls, "GET", "/healthz")
        for status, retry_after, _, dt_s in chaos:
            if status != 503 or retry_after is None or dt_s > 1.0 + 0.5:
                raise AssertionError(f"under a hung dispatch: {chaos}")
        if [m for _, _, m, _ in chaos] != ["micro-batch dispatch: deadline exceeded"] * 2 + [
                "serving temporarily unavailable (dispatch circuit open)"]:
            raise AssertionError(f"under a hung dispatch: {chaos}")
        if on.batcher.watchdog_trips != 2 or hz_status != 503 or hz["breakers"]["dispatch"]["state"] != "open":
            raise AssertionError(f"trips {on.batcher.watchdog_trips}, /healthz {hz_status} {hz}")
        injector.clear()
        lane.algorithms[0] = real
        t_clear = time.perf_counter()
        _wait(lambda: on.dispatch_breaker.state == "half-open", 5, "half-open")
        steps["half_open_s"] = time.perf_counter() - t_clear
        probe = _one_call(on_port, tls, "POST", qpath, {"user": users[0], "num": 10})
        steps["breaker_closed_s"] = time.perf_counter() - t_clear
        if probe[0] != 200 or on.dispatch_breaker.state != "closed":
            raise AssertionError(f"the half-open probe: {probe[:3]}, breaker {on.dispatch_breaker.state}")
        outs, _ = drive(on_port, tls, qpath, users[:64], clients=1)
        if any(o[0] != 200 for o in outs):
            raise AssertionError("a query after the breaker closed was not answered 200")
        for u, (_, _, body, _) in zip(users, outs):
            held(u, body, "after the breaker closed")
        answered_on += 1 + len(outs)

        def burst_round(dispatch_s: float) -> int:
            """Every client connected first, then all send at once; with
            ``dispatch_s`` each dispatch takes that much longer (a slower
            device), so the queue reaches high water. Returns the shed."""
            conns = []
            with concurrent.futures.ThreadPoolExecutor(32) as pool:
                conns = list(pool.map(lambda _: _Conn(on_port, tls), range(burst)))
                list(pool.map(lambda c: c.conn.connect(), conns))
            gate = threading.Barrier(burst)

            def fire(j):
                gate.wait()
                try:
                    return conns[j].call("POST", qpath, {"user": users[j], "num": 10})
                except OSError as exc:
                    return ("error", None, repr(exc), 0.0)

            slow = FaultInjector(real)
            if dispatch_s:
                slow.inject("predict_batch_dispatch", latency_s=dispatch_s)
                lane.algorithms[0] = slow
            try:
                with concurrent.futures.ThreadPoolExecutor(burst) as pool:
                    fired = list(pool.map(fire, range(burst)))
            finally:
                lane.algorithms[0] = real
            for c in conns:
                c.close()
            shed = [f for f in fired if f[0] == 503]
            ok = [(j, f) for j, f in enumerate(fired) if f[0] == 200]
            if len(shed) + len(ok) != burst or any(
                    f[1] is None or not f[2]["message"].startswith("admission queue over high water")
                    for f in shed):
                raise AssertionError(f"burst: {sorted({str(f[0]) for f in fired})}, e.g. "
                                     f"{[f for f in fired if f[0] not in (200, 503)][:3]} {shed[:2]}")
            for j, (_, _, body, _) in ok:
                held(users[j], body, "the burst")
            nonlocal answered_on
            answered_on += len(ok)
            return len(shed)

        shed_fast = burst_round(0.0)
        shed_slow = burst_round(0.2)
        if not shed_slow:
            raise AssertionError("a burst on a dispatch 0.2 s slower shed nothing")
        steps.update(burst=burst, burst_shed=shed_fast, burst_shed_share=shed_fast / burst,
                     slow_burst_shed=shed_slow, slow_burst_shed_share=shed_slow / burst,
                     burst_500s=0, burst_resets=0, shed_count=on.batcher.shed_count)

        time.sleep(2.6)  # the calls walked away from return, unread
        mem_after = _tensor_bytes(torch)
        if mem_after > 1.1 * mem_before:
            raise AssertionError(f"card memory grew over the chaos: {mem_before} -> {mem_after}")
        def app_events():
            return len(list(storage.get_l_events().find(app_id, entity_type="pio_pr")))

        steps["feedback_landed_s"] = _wait(lambda: app_events() >= answered_on, 120, "the predict events")
        if app_events() != answered_on:
            raise AssertionError(f"{app_events()} predict events for {answered_on} answered queries")
    finally:
        on.shutdown()
        off.shutdown()
        es.shutdown()
        collector.close()
        remove_work(work)
    result = {"host_numbers": True, **steps, "queries": n_queries, "watchdog_trips": 2,
              "chaos_503_s": [round(c[3], 4) for c in chaos], "memory_allocated": [mem_before, mem_after],
              "predict_events": answered_on, "spd_cg_launches": spd_solve.batched_spd_solve_fused.launches}
    emit(phase="serving_contract_inprocess", shape=[len(model.user_vocab), len(vocab), 32], **result)
    return result

# the families the JAX package's query server registers
# (tests/test_resilience.py's factory) less the port's written exemptions:
# the five jit/XLA families (no jit cache in eager PyTorch);
# tests/test_torch_obs.py holds this list to that difference
CONTRACT_FAMILIES = (
    "pio_ann_candidates_frac", "pio_ann_candidates_total", "pio_ann_fallback_total",
    "pio_ann_index_clusters", "pio_ann_index_items", "pio_ann_probes_total", "pio_ann_queries_total",
    "pio_ann_rebuilds_total", "pio_ann_recall_sampled", "pio_ann_recall_samples_total",
    "pio_ann_refreshes_total", "pio_bandit_active", "pio_bandit_fraction",
    "pio_bandit_impressions_evicted_total", "pio_bandit_matched_rewards_total", "pio_bandit_p_candidate_better",
    "pio_bandit_promotions_total", "pio_bandit_pulls_total", "pio_bandit_regret_pulls",
    "pio_bandit_retirements_total", "pio_bandit_reward_rate", "pio_bandit_rewards_total",
    "pio_bandit_unmatched_rewards_total", "pio_breaker_rejections_total", "pio_breaker_state",
    "pio_breaker_transitions_total", "pio_cache_evictions_total", "pio_cache_hits_total",
    "pio_cache_invalidations_total", "pio_cache_misses_total", "pio_deadline_exceeded_total",
    "pio_device_stall_seconds_total", "pio_dispatch_seconds", "pio_fetch_seconds", "pio_load_shed_total",
    "pio_model_errors_total", "pio_model_predict_seconds", "pio_model_requests_total", "pio_phase_seconds",
    "pio_profile_bundles", "pio_profile_capture_busy_total", "pio_profile_capture_errors_total",
    "pio_profile_captures_total", "pio_profile_last_capture_ms", "pio_profile_sampler_overhead_frac",
    "pio_profile_sampler_samples_total", "pio_profile_sampler_stacks", "pio_promotions_total",
    "pio_queue_depth", "pio_queue_high_water", "pio_queue_wait_seconds", "pio_registry_lease_acquires_total",
    "pio_registry_lease_generation", "pio_registry_lease_lost_total", "pio_registry_lease_steals_total",
    "pio_registry_lease_waits_total", "pio_request_seconds", "pio_requests_total", "pio_rollbacks_total",
    "pio_rollout_fraction", "pio_rollout_mode", "pio_shadow_divergence_total", "pio_shadow_dropped_total",
    "pio_shadow_scored_total", "pio_slo_alerting", "pio_slo_bad_ratio", "pio_slo_burn_rate",
    "pio_slo_objective", "pio_watchdog_trips_total",
)
PHASES = ("ingress_parse", "cache", "queue_wait", "batch_assembly", "dispatch", "device_compute", "fetch",
          "serve", "respond")
_SAMPLE = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})? (\S+)(?: # \{trace_id="([0-9a-f]+)"\} \S+)?$')


def parse_metrics(text: str) -> dict:
    """Family -> [(labels, value, exemplar trace id or None)] of a
    Prometheus or OpenMetrics scrape; a family declared by ``# TYPE`` with
    no sample is present with no samples. Raises on a line it cannot read."""
    out: dict[str, list] = {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            out.setdefault(line.split()[2], [])
            continue
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE.match(line)
        if m is None:
            raise AssertionError(f"unparsable metrics line: {line!r}")
        labels = dict(re.findall(r'([a-zA-Z_]\w*)="((?:[^"\\]|\\.)*)"', m.group(2) or ""))
        name = m.group(1)
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and name[: -len(suffix)] in out:
                name = name[: -len(suffix)]
        out.setdefault(name, []).append((labels, float(m.group(3)), m.group(4)))
    return out


def emit_numbers(phase: str, **numbers) -> None:
    """One line per number, with the card's name and power limit."""
    for name, value in numbers.items():
        emit(phase=phase, metric=name, value=value, gpu=GPU)


class _TracedConn:
    """A keep-alive client that sends X-Pio-Trace-Id and returns (status,
    echoed trace id, decoded body, seconds)."""

    def __init__(self, port: int):
        import http.client

        self.conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)

    def call(self, path: str, payload, trace_id: str):
        t0 = time.perf_counter()
        self.conn.request("POST", path, body=json.dumps(payload).encode(),
                          headers={"Content-Type": "application/json", "X-Pio-Trace-Id": trace_id})
        resp = self.conn.getresponse()
        body = json.loads(resp.read())
        return resp.status, resp.getheader("X-Pio-Trace-Id"), body, time.perf_counter() - t0

    def close(self) -> None:
        self.conn.close()

    def query(self, payload, trace_id: str):
        """POST /queries.json: (status, answering model version, decoded
        body, seconds)."""
        t0 = time.perf_counter()
        self.conn.request("POST", "/queries.json", body=json.dumps(payload).encode(),
                          headers={"Content-Type": "application/json", "X-Pio-Trace-Id": trace_id})
        resp = self.conn.getresponse()
        body = json.loads(resp.read())
        return resp.status, resp.getheader("X-Pio-Model-Version"), body, time.perf_counter() - t0


def _profiler_ready(base: str, timeout: float = 120.0) -> float:
    """Wait until the server's profiler has set CUPTI up (``GET /``);
    returns the seconds waited."""
    return _wait(lambda: _http(base + "/")[1]["profiling"]["ready"], timeout, "the profiler's warm-up")


def _conflicting_capture(base: str, out: list) -> None:
    """Wait until the server reports a capture in flight (``GET /``), then
    POST another: ``out`` receives its status."""
    t0 = time.perf_counter()
    while not _http(base + "/")[1]["profiling"]["captureInFlight"]:
        if time.perf_counter() - t0 > 60:
            out.append("no capture in flight within 60 s")
            return
        time.sleep(0.01)
    try:
        _http(base + "/profile/capture?ms=0", {})
        out.append(200)
    except urllib.error.HTTPError as exc:
        out.append(exc.code)


def _get(base: str, path: str, headers=None):
    req = urllib.request.Request(base + path, headers=headers or {})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, resp.headers.get("Content-Type", ""), resp.read().decode()


@phase
def obs_inprocess_phase(torch, foldin: dict, contract: dict, n_users: int = 1_000, clients: int = 16) -> dict:
    """Observability at full width: the ML-20M model the fold-in published
    as stable (138,000 x 27,000, rank 32) in a QueryServer on the card with
    the result cache at 1,024 entries and a 10 s TTL. 1,000 distinct users
    from 16 clients, then the same 1,000 again once every first answer is
    in, each query with its own X-Pio-Trace-Id: every answer serve_batch's,
    hits and misses 1,000 each, every id echoed and in /traces/recent, the
    misses' phase means summing to within 10 % of their mean
    pio_request_seconds, /metrics parsed with every contract family, an
    OpenMetrics scrape whose exemplars resolve in /traces/recent, /slo's
    three objectives. Then two 500 ms captures, one after the other, while
    other users' queries flow (a third capture POSTed during the first
    answers 409), each trace holding more kernels than the capture's own
    marker; card memory held by tensors flat across all of it."""
    import uuid

    from predictionio_tpu_torch.models.recommendation import engine as rec
    from predictionio_tpu_torch.obs.tracing import Tracer
    from predictionio_tpu_torch.workflow import model_io
    from predictionio_tpu_torch.workflow.context import WorkflowContext
    from predictionio_tpu_torch.workflow.create_server import QueryServer, ServerConfig
    from predictionio_tpu_torch.workflow.engine_loader import EngineManifest

    engine = rec.engine_factory()
    ep = engine.engine_params_from_variant({"algorithms": [{"name": "als", "params": {"rank": 32}}]})
    ctx = WorkflowContext(mode="serving", device="cuda", _storage=foldin["storage"])
    (model,) = engine.prepare_deploy(ctx, ep, model_io.deserialize_models(foldin["stable_blob"]))
    work = work_dir(prefix="pio_smoke_obs_")
    server = QueryServer(engine, ep, [model], ctx, ServerConfig(
        ip="127.0.0.1", port=0, result_cache_size=1024, result_cache_ttl_s=10.0,
        profile_dir=os.path.join(work, "profiles")), "obs",
        manifest=EngineManifest("smoke-obs", "1", "engine.json", REC_FACTORY))
    # a ring that holds the whole run's spans (two a query)
    server.tracer = Tracer(ring_size=16_384)
    port = server.start()
    base = f"http://127.0.0.1:{port}"
    users = [f"u{i}" for i in range(n_users)]
    uidx = np.asarray([model.user_index(u) for u in users], dtype=np.int32)
    # 20 columns for answers of 10: a run of tied scores cut at k is seen
    ref_scores, ref_ids = model.serving_index().serve_batch(uidx, 20)

    def drive(us):
        local = threading.local()

        def one(j):
            if not hasattr(local, "conn"):
                local.conn = _TracedConn(port)
            tid = uuid.uuid4().hex[:16]
            return (j, tid, *local.conn.call("/queries.json", {"user": us[j], "num": 10}, tid))

        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(clients) as pool:
            outs = list(pool.map(one, range(len(us))))
        wall = time.perf_counter() - t0
        for j, tid, status, echoed, body, _ in outs:
            if status != 200 or echoed != tid:
                raise AssertionError(f"{us[j]}: status {status}, trace id {tid} echoed as {echoed}")
            # a micro-batch's shape is not the reference's, so scores agree
            # to rounding and near-tied ids may trade places (_same_topk)
            _same_topk(np.asarray([[model.item_index(x["item"]) for x in body["itemScores"]]]),
                       np.asarray([[x["score"] for x in body["itemScores"]]]), ref_ids[j:j + 1],
                       ref_scores[j:j + 1], 1e-5, f"{us[j]}: not serve_batch's answer")
        return outs, wall

    def in_ring(outs, what):
        _, _, text = _get(base, "/traces/recent?limit=16384")
        ring = {s["traceId"] for s in json.loads(text)["spans"]}
        missing = [tid for _, tid, *_ in outs if tid not in ring]
        if missing:
            raise AssertionError(f"{what}: {len(missing)} trace ids not in /traces/recent, e.g. {missing[:3]}")

    steps = {}
    try:
        mem_before = _tensor_bytes(torch)
        first = users
        misses, wall_miss = drive(first)
        in_ring(misses, "misses")
        hist, lat = server.waterfall.hist, server._m_latency
        phase_means = {p: hist.summary(phase=p)["mean"] for p in PHASES}
        request_mean = lat.summary(endpoint="/queries.json")["mean"]
        tiling = sum(phase_means.values()) / request_mean
        if not 0.9 <= tiling <= 1.1:
            raise AssertionError(f"phase means sum to {tiling:.4f} of the mean request time: {phase_means}")
        hits, wall_hit = drive(first)
        in_ring(hits, "hits")
        cache = server._result_cache
        if (cache.hits, cache.misses) != (n_users, n_users):
            raise AssertionError(f"cache hits {cache.hits}, misses {cache.misses}; expected {n_users} each")
        _, ctype, text = _get(base, "/metrics")
        parsed = parse_metrics(text)
        if not ctype.startswith("text/plain") or "trace_id" in text:
            raise AssertionError(f"the default scrape is not plain Prometheus text: {ctype}")
        missing = [f for f in CONTRACT_FAMILIES if f not in parsed]
        if missing:
            raise AssertionError(f"/metrics lacks contract families {missing}")
        if parsed["pio_cache_hits_total"][0][1] != n_users or parsed["pio_cache_misses_total"][0][1] != n_users:
            raise AssertionError(f"/metrics cache counters {parsed['pio_cache_hits_total']} "
                                 f"{parsed['pio_cache_misses_total']}")
        _, ctype, text = _get(base, "/metrics", {"Accept": "application/openmetrics-text"})
        exemplars = {labels.get("phase"): tid for labels, _, tid in parse_metrics(text)["pio_phase_seconds"]
                     if tid is not None}
        _, _, ring_text = _get(base, "/traces/recent?limit=16384")
        ring = {sp["traceId"] for sp in json.loads(ring_text)["spans"]}
        if not ctype.startswith("application/openmetrics-text") or set(exemplars) != set(PHASES) \
                or not set(exemplars.values()) <= ring:
            raise AssertionError(f"OpenMetrics exemplars {exemplars} ({ctype}) do not resolve in the ring")
        _, _, slo_text = _get(base, "/slo")
        slo = json.loads(slo_text)
        if [o["name"] for o in slo["slos"]] != ["latency", "availability", "shed"]:
            raise AssertionError(f"/slo: {slo['slos']}")

        # two captures, one after the other, while other users' queries flow
        warmup_wait_s = _profiler_ready(base)
        captures, conflict, done = [], [], threading.Event()

        def capture_twice():
            try:
                for _ in range(2):
                    t0 = time.perf_counter()
                    status, body, _ = _http(base + "/profile/capture?ms=500", {}, timeout=120)
                    captures.append((status, body, time.perf_counter() - t0))
            finally:
                done.set()

        def pump(k):
            conn, u = _TracedConn(port), 2_000 + k
            while not done.is_set():
                status, *_ = conn.call("/queries.json", {"user": f"u{u}", "num": 10}, uuid.uuid4().hex[:16])
                if status != 200:
                    raise AssertionError(f"u{u} answered {status} during a capture")
                u += clients

        threads = [threading.Thread(target=capture_twice),
                   threading.Thread(target=_conflicting_capture, args=(base, conflict))]
        for t in threads:
            t.start()
        with concurrent.futures.ThreadPoolExecutor(clients) as pool:
            list(pool.map(pump, range(clients)))
        for t in threads:
            t.join(60)
        if [c[0] for c in captures] != [200, 200] or conflict != [409]:
            raise AssertionError(f"captures {[c[:1] for c in captures]}, the concurrent one {conflict}")
        kernels = [sum(c[1]["kernels"].values()) for c in captures]
        if min(kernels) < 2:  # the capture's own marker is one
            raise AssertionError(f"a capture during serving recorded {kernels} kernels")
        mem_after = _tensor_bytes(torch)
        if mem_after - mem_before > max(4 << 20, 0.01 * mem_before):
            raise AssertionError(f"card memory grew across the queries and captures: {mem_before} -> {mem_after}")
        miss_lat = [o[5] for o in misses]
        hit_lat = [o[5] for o in hits]
        steps = {
            "queries_miss": n_users, "queries_hit": n_users, "clients": clients,
            "miss_p50_ms": _p50_ms(miss_lat), "miss_qps": n_users / wall_miss,
            "hit_p50_ms": _p50_ms(hit_lat), "hit_qps": n_users / wall_hit,
            "contract_off_p50_ms": contract["p50_off_ms"], "contract_off_qps": contract["qps_off"],
            "phase_tiling": tiling, "request_mean_ms": request_mean * 1e3,
            **{f"phase_{p}_mean_ms": v * 1e3 for p, v in phase_means.items()},
            "cache_hit_phase_mean_ms": hist.summary(phase="cache")["mean"] * 1e3,
            "sampler_overhead_frac": server.sampler.overhead_frac(),
            "sampler_samples": server.sampler.snapshot()["samples"],
            "capture_kernels": kernels, "capture_wall_s": [c[2] for c in captures],
            "profiler_warmup_wait_s": warmup_wait_s,
            "capture_timings_s": [json.load(open(os.path.join(c[1]["path"], "manifest.json")))["context"][
                "captureTimingsS"] for c in captures],
            "capture_trace_bytes": [sum(e["bytes"] for e in
                                        json.load(open(os.path.join(c[1]["path"], "manifest.json")))["trace"])
                                    for c in captures],
            "memory_allocated_before": mem_before, "memory_allocated_after": mem_after,
            "slo_alerting": {o["name"]: o["alerting"] for o in slo["slos"]},
            "slo_burn_rates": {o["name"]: [w["burn_rate"] for w in o["windows"]] for o in slo["slos"]},
            "contract_families": len(CONTRACT_FAMILIES), "families_scraped": len(parsed),
        }
    finally:
        server.shutdown()
        remove_work(work)
    emit_numbers("obs_inprocess", **steps)
    return steps



# ---------------------------------------------------------------------------
# the bandit lanes (predictionio_tpu_torch/bandit)
# ---------------------------------------------------------------------------

BANDIT_ENGINE = "smoke-bandit"
BANDIT_ROUNDS = ({"candidate": 0.30, "stable": 0.15, "verdict": "promote"},
                 {"candidate": 0.05, "stable": 0.30, "verdict": "retire"})


def _bandit_registry(foldin: dict, work: str, engine_id: str = BANDIT_ENGINE) -> tuple[str, list[str]]:
    """A registry of its own: the fold-in's stable blob as v000001 (the
    ML-20M model, rank 32) and its last candidate's blob as v000002."""
    from predictionio_tpu_torch.registry import ArtifactStore, ModelManifest

    store, src = ArtifactStore(os.path.join(work, "registry")), foldin["store"]
    versions = []
    for blob in (foldin["stable_blob"], src.load_blob(STREAM_ENGINE, foldin["published"][-1])):
        versions.append(store.publish(ModelManifest(version="", engine_id=engine_id, engine_version="1",
                                                    engine_variant="engine.json"), blob).version)
    return store.base_dir, versions


@phase
def bandit_inprocess_phase(torch, foldin: dict, clients: int = 16, wave: int = 128, seed: int = 43,
                           max_queries: int = 40_000, n_users: int = 138_000) -> dict:
    """The bandit lanes at full width: a QueryServer on the card deployed
    from a registry whose v000001 is the ML-20M stable (138,000 x 27,000,
    rank 32) and v000002 the fold-in's candidate, with bandit_policy
    "thompson" and its reward app in the server's own (the fold-in's sqlite)
    store. Round one stages v000002 at 0.1: waves of 128 queries from 16
    clients (users drawn from a seed, each query with its own
    X-Pio-Trace-Id); each answered user converts with its arm's
    probability (numpy, fixed seed: candidate 0.30, stable 0.15) and the
    conversion is a reward event carrying the answer's trace id; one bake
    tick after each wave, until the bandit promotes. Round two re-stages
    v000001 as the candidate (0.05 against the new stable's 0.30) until it
    retires. The ticks run between waves, so each round's accounting is
    exact: every answer 200 and equal to its lane's serve_batch, pulls per
    arm equal to the answers per arm, matched rewards equal to the reward
    events (every one of a live impression), pio_bandit_active 1 during
    the round and 0 after, the registry's state and bandit.json ended as
    the verdict; card memory held by tensors flat across both swaps. The
    bandit's server keeps the gate's default latency veto (1.5x, the two
    lanes compared at one batch size: ROADMAP C16; a veto needs more slow
    candidate batches than an equal lane's tail gives: C20); each round
    keeps the largest and the last latency ratio the veto read, and its
    (slow batches, batches, slow batches a veto needs). The same waves
    through a server with the plain bake gate (no bandit, a canary at 0.5)
    give the p50 and qps beside it."""
    import uuid

    from predictionio_tpu_torch.data.event import Event
    from predictionio_tpu_torch.data.storage.base import App
    from predictionio_tpu_torch.workflow.context import WorkflowContext
    from predictionio_tpu_torch.workflow.create_server import ServerConfig, create_query_server

    storage = foldin["storage"]
    work = work_dir(prefix="pio_smoke_bandit_")
    registry, (v1, v2) = _bandit_registry(foldin, work)
    engine_dir = _engine_dir(os.path.join(work, "engine"), BANDIT_ENGINE, "streamapp", {"rank": 32})
    app_id = storage.get_meta_data_apps().insert(App(0, "banditrewards"))
    levents = storage.get_l_events()
    levents.init(app_id)
    ctx = WorkflowContext(mode="serving", device="cuda", _storage=storage)
    users_rng, convert_rng = np.random.default_rng(seed), np.random.default_rng(seed + 1)

    opened: list = []

    def serve(bandit: bool):
        config = ServerConfig(ip="127.0.0.1", port=0, registry_dir=registry, bake_check_interval_s=3600.0,
                              bake_window_s=1.0, bake_min_requests=20,
                              profile_dir=os.path.join(work, "profiles"),
                              **({"bandit_policy": "thompson", "bandit_app_name": "banditrewards"}
                                 if bandit else {}))
        server = create_query_server(engine_dir, ctx, config)
        port = server.start()
        # one keep-alive connection a client, open until the phase ends:
        # across every swap, the plain server's shutdown and each reading
        # of card memory
        fresh = [_TracedConn(port) for _ in range(clients)]
        opened.extend(fresh)
        conns = queue.Queue()
        for conn in fresh:
            conns.put(conn)
        return server, port, conns

    def drive(conns, n):
        users = [f"u{u}" for u in users_rng.integers(0, n_users, n)]

        def one(j):
            conn = conns.get()
            try:
                tid = uuid.uuid4().hex[:16]
                return (tid, *conn.query({"user": users[j], "num": 10}, tid))
            finally:
                conns.put(conn)

        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(clients) as pool:
            outs = list(pool.map(one, range(n)))
        wall = time.perf_counter() - t0
        bad = [o for o in outs if o[1] != 200]
        if bad:
            raise AssertionError(f"{len(bad)} of {n} answers not 200, e.g. {bad[0][1:3]}")
        return users, outs, wall

    def active_gauge(port):
        return parse_metrics(_get(f"http://127.0.0.1:{port}", "/metrics")[2])["pio_bandit_active"][0][1]

    steps: dict = {}
    # the plain bake gate: a canary at 0.5 that never promotes in the window
    plain, port, conns = serve(bandit=False)
    try:
        plain.stage_from_registry(v2, fraction=0.5)
        lat, wall = [], 0.0
        for _ in range(8):
            _, outs, w = drive(conns, wave)
            lat += [o[4] for o in outs]
            wall += w
        steps["plain_gate_p50_ms"], steps["plain_gate_qps"] = _p50_ms(lat), len(lat) / wall
        plain._rollback_candidate("manual")
    finally:
        plain.shutdown()
        del plain
    server, port, conns = serve(bandit=True)
    store, ins = server.registry_store, server.bandit_instruments
    decisions = []
    tick = server.bandit.tick

    def recording_tick():
        d = tick()
        decisions.append(d)
        return d

    server.bandit.tick = recording_tick
    rounds, lat, wall = [], [], 0.0
    try:
        memory = [_tensor_bytes(torch)]
        for r, rates in enumerate(BANDIT_ROUNDS):
            cand_version = v2 if r == 0 else v1
            server.stage_from_registry(cand_version, fraction=0.1)
            if not server.bandit.active:
                raise AssertionError("the bandit did not engage on the staged candidate")
            stable_lane, cand_lane, _, _ = server.lanes()
            matched0, answers, conversions = ins.matched.value(), {"stable": [], "candidate": []}, \
                {"stable": 0, "candidate": 0}
            seen_active = False
            n, p95_ratios, slow_reads = 0, [], []
            while server._candidate is not None:
                if n >= max_queries:
                    raise AssertionError(f"round {r + 1}: no verdict after {n} queries: {server.bandit.snapshot()}")
                users, outs, w = drive(conns, wave)
                n += len(outs)
                wall += w
                for user, (tid, _, version, body, dt_s) in zip(users, outs):
                    arm = "candidate" if version == cand_version else "stable"
                    answers[arm].append((user, body, version, dt_s))
                    lat.append(dt_s)
                    if convert_rng.random() < rates[arm]:
                        conversions[arm] += 1
                        levents.insert(Event(event="reward", entity_type="user", entity_id=user,
                                             properties={"traceId": tid}), app_id)
                seen_active = seen_active or active_gauge(port) == 1.0
                # what the gate's latency veto (1.5x, the default) reads:
                # the p95 ratio, and the candidate's slow batches against
                # the count a veto needs
                read = server.rollout_controller.latency_read()
                if read["candidate_p95"] > 0 and read["stable_p95"] > 0:
                    p95_ratios.append(read["candidate_p95"] / read["stable_p95"])
                    slow_reads.append((read["slow"], read["samples"], read["slow_needed"]))
                server._rollout_tick()
            verdict = decisions[-1]
            saved = store.load_bandit_state(BANDIT_ENGINE)
            state = store.get_state(BANDIT_ENGINE)
            for arm in ("stable", "candidate"):
                got = answers[arm]
                if got:
                    _lane_answers_held(server, stable_lane if arm == "stable" else cand_lane,
                                       [(200, b, v, d) for _, b, v, d in got],
                                       [u for u, *_ in got], f"round {r + 1} {arm} answers")
                if saved[arm]["pulls"] != len(got) or saved[arm]["rewards"] != conversions[arm]:
                    raise AssertionError(f"round {r + 1} {arm}: {saved[arm]} for {len(got)} answers and "
                                         f"{conversions[arm]} conversions")
            matched = ins.matched.value() - matched0
            want_stable = (cand_version if rates["verdict"] == "promote" else stable_lane.version)
            if (verdict.verdict != rates["verdict"] or saved.get("ended") != rates["verdict"]
                    or matched != sum(conversions.values()) or not seen_active or active_gauge(port) != 0.0
                    or state.stable != want_stable or state.candidate or server.model_version != want_stable):
                raise AssertionError(f"round {r + 1}: verdict {verdict}, saved {saved}, matched {matched} of "
                                     f"{conversions}, active seen {seen_active}, latency veto's p95 ratios "
                                     f"{p95_ratios[-4:]} and (slow, batches, needed) {slow_reads[-4:]}, "
                                     f"state {state.to_json_dict()}")
            del stable_lane, cand_lane
            memory.append(_tensor_bytes(torch))
            rounds.append({"verdict": verdict.verdict, "queries_to_verdict": n, "p_better": verdict.p_better,
                           "final_fraction": verdict.fraction, "regret_pulls": ins.regret_pulls.value(),
                           "pulls": {a: len(v) for a, v in answers.items()}, "rewards": conversions,
                           "matched_rewards": matched, "max_p95_ratio_read": max(p95_ratios, default=None),
                           "p95_ratio_at_verdict": p95_ratios[-1] if p95_ratios else None,
                           "max_slow_batches_read": max(slow_reads, default=None,
                                                        key=lambda r: r[0] / r[2] if r[2] else 0.0),
                           "slow_batches_at_verdict": slow_reads[-1] if slow_reads else None,
                           "rates": {k: v for k, v in rates.items() if k != "verdict"}})
        if max(memory) > 1.1 * min(memory):
            raise AssertionError(f"card memory held by tensors moved across the swaps: {memory}")
        metrics = parse_metrics(_get(f"http://127.0.0.1:{port}", "/metrics")[2])
        statuses = {lab["status"] for lab, _, _ in metrics["pio_requests_total"]}
        if any(s.startswith("5") for s in statuses):
            raise AssertionError(f"5xx answers: {metrics['pio_requests_total']}")
    finally:
        server.shutdown()
        for conn in opened:
            conn.close()
        remove_work(work)
    steps.update({"rounds": rounds, "clients": clients, "wave": wave, "bandit_p50_ms": _p50_ms(lat),
                  "bandit_qps": len(lat) / wall, "memory_allocated": memory,
                  "promotions": ins.promoted.value(), "retirements": ins.retired.value()})
    emit_numbers("bandit_inprocess", **steps)
    return steps


FLEET_ENGINE = "smoke-fleet"


def _fleet_ports(n: int = 4) -> int:
    """A base port whose next ``n`` ports are free: the gateway, then the
    workers in the launcher's order. Below Linux's ephemeral range (32768
    up), so a client polling a worker's port before it listens is never
    handed that port as its own source port (a TCP self-connect reads back
    its own request)."""
    rng = np.random.default_rng()
    for _ in range(200):
        base = int(rng.integers(20_000, 32_000 - n))
        socks = []
        try:
            for p in range(base, base + n):
                s = socket.socket()
                socks.append(s)
                s.bind(("127.0.0.1", p))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise AssertionError(f"no {n} free consecutive ports")


def _pid_on_port(port: int) -> int | None:
    """The pid of the port's CLI process whose argv names ``--port port``."""
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/cmdline", "rb") as fh:
                argv = fh.read().split(b"\0")
        except OSError:
            continue
        if b"predictionio_tpu_torch.tools.cli" in argv and b"--port" in argv \
                and argv[argv.index(b"--port") + 1] == str(port).encode():
            return int(name)
    return None


def _worker_images(pid: int) -> dict:
    """What a worker process runs: its argv, whether it maps the card's
    device files (a CUDA context does), and any JAX or aiohttp image."""
    with open(f"/proc/{pid}/cmdline", "rb") as fh:
        argv = [a.decode() for a in fh.read().split(b"\0") if a]
    with open(f"/proc/{pid}/maps") as fh:
        maps = fh.read()
    foreign = sorted({ln.split()[-1] for ln in maps.splitlines()
                      if "jaxlib" in ln or "/jax/" in ln or "aiohttp" in ln})
    return {"argv": argv, "cuda_context": "/dev/nvidia" in maps, "foreign_images": foreign}


def _compute_apps() -> list[str]:
    """nvidia-smi's compute apps, one "pid, used MiB" line each (the pid is
    the host's, which this process cannot map to its own)."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout
    return [ln.strip() for ln in out.splitlines() if ln.strip()]


def _card_used(torch) -> int:
    """Bytes in use on the card, every process's (nvidia-smi's per-process
    figures on the chip machine repeat one container-wide number)."""
    if not torch.cuda.is_available():
        return 0
    free, total = torch.cuda.mem_get_info()
    return int(total - free)


def _fleet_query_run(port: int, users: list, clients: int) -> tuple[list, float]:
    """Each user's query (num 10) through one of ``clients`` keep-alive
    connections: [(user, status, body, seconds)] in order, and the wall."""
    conns: queue.Queue = queue.Queue()
    opened = [_Conn(port) for _ in range(clients)]
    for c in opened:
        conns.put(c)

    def one(u):
        conn = conns.get()
        try:
            status, _, body, dt = conn.call("POST", "/queries.json", {"user": u, "num": 10})
            return u, status, body, dt
        finally:
            conns.put(conn)

    t0 = time.perf_counter()
    try:
        with concurrent.futures.ThreadPoolExecutor(clients) as pool:
            outs = list(pool.map(one, users))
    finally:
        for c in opened:
            c.close()
    return outs, time.perf_counter() - t0


def _fleet_answers_held(model, outs, what: str) -> None:
    """Every answer 200 and serve_batch's on the card (tie-aware, rtol 1e-5)."""
    bad = [o for o in outs if o[1] != 200]
    if bad:
        raise AssertionError(f"{what}: {len(bad)} of {len(outs)} answers not 200, e.g. {bad[0][1:3]}")
    got_ids = np.asarray([[model.item_index(x["item"]) for x in body["itemScores"]] for _, _, body, _ in outs])
    got_scores = np.asarray([[x["score"] for x in body["itemScores"]] for _, _, body, _ in outs])
    uidx = np.asarray([model.user_index(u) for u, *_ in outs], dtype=np.int32)
    ref_scores, ref_ids = model.serving_index().serve_batch(uidx, 20)
    _same_topk(got_ids, got_scores, ref_ids, ref_scores, 1e-5, what)


def _forwards_by_replica(base: str) -> dict:
    """The gateway's 2xx forwards per replica so far."""
    out: dict = {}
    for lab, v, _ in parse_metrics(_get(base, "/metrics")[2]).get("pio_fleet_requests_total", []):
        if lab.get("status") == "2xx":
            out[lab["replica"]] = out.get(lab["replica"], 0.0) + v
    return out


def _ring_summary(obs: str, n: int = 40) -> list:
    """The fleet ring's last records, for a failing phase's report: each
    snapshot's gauges, shape and fast burns, each scaling decision."""
    from predictionio_tpu_torch.obs.tsring import TelemetryRing

    try:
        records = TelemetryRing(os.path.join(obs, "telemetry")).records()
    except OSError:
        return []
    out = []
    for r in records[-n:]:
        if r.get("kind") == "fleet":
            out.append({"t": r.get("t"), "gauges": r.get("gauges"), "shape": r.get("shape"),
                        "burn": {k: min(v["burn"].items(), key=lambda kv: float(kv[0]))[1]
                                 for k, v in (r.get("slo") or {}).items() if v.get("burn")}})
        else:
            out.append(r)
    return out


@phase
def fleet_cli_phase(torch, foldin: dict, clients: int = 16, n_queries: int = 2_000,
                    flood_clients: int = 48, seed: int = 53, device: str = "cuda") -> dict:
    """The serving fleet through the port's CLI at full width: a registry
    whose v000001 is the ML-20M stable (138,000 x 27,000, rank 32) and
    v000002 the fold-in's candidate; ``pio deploy --fleet 2 --fleet-max 2
    --autoscale --cpu-fallback-max 1 --autoscale-interval 0.5
    --fleet-probe-interval 0.3 --obs-dir O`` (the parent through the
    counting launcher, its two device workers ``-m`` processes of the
    CLI; no worker maps a JAX or aiohttp image). Then: 2,000 queries from
    16 clients through the gateway and the same queries straight to w0,
    every answer 200 and serve_batch's (p50 and qps of both: the gateway's
    hop; each replica's share); nvidia-smi's compute apps (one more per
    device worker, each worker mapping the card); w0 SIGKILLed amid
    traffic (no answer but 200; the seconds to its restart and its
    readmission; a worker-crash bundle with its stderr tail); a flood from
    48 clients until the gateway routes to a cpu-fallback replica (within
    60 s of the flood; its direct answers serve_batch's; it maps no card
    and adds no compute app). 48, not 32: the autoscaler's default
    in-flight threshold is 16 a replica, and 32 closed-loop clients keep
    at most 28-32 in flight at the gateway, while the workers' own request
    p50 stays under the latency SLO's 10 ms; v000002 staged and promoted through the
    gateway, every worker on the new stable within the sync interval plus
    2 s; ``pio top --fleet --once --json``; SIGTERM: exit 0 within the
    grace, and no worker left, on the card or off it."""
    from predictionio_tpu_torch.obs.incidents import list_bundles, load_bundle
    from predictionio_tpu_torch.workflow import model_io

    work = work_dir(prefix="pio_smoke_fleet_")
    registry, (v1, v2) = _bandit_registry(foldin, work, FLEET_ENGINE)
    engine_dir = _engine_dir(os.path.join(work, "engine"), FLEET_ENGINE, "streamapp", {"rank": 32})
    store = foldin["store"]
    models = {v: model_io.deserialize_models(blob)[0] for v, blob in (
        (v1, foldin["stable_blob"]), (v2, store.load_blob(STREAM_ENGINE, foldin["published"][-1])))}
    for model in models.values():
        model.device = device
    n_users = len(models[v1].user_vocab)
    env = {**os.environ, "PYTHONPATH": os.path.dirname(os.path.abspath(__file__))}
    session = _CliSession(work, os.path.join(work, "home"), env)
    steps: dict = {}
    obs = os.path.join(work, "obs")
    port = _fleet_ports()
    base = f"http://127.0.0.1:{port}"
    rng = np.random.default_rng(seed)
    for model in models.values():  # the references' tables on the card before the baseline
        model.serving_index()
    apps0, used0 = _compute_apps(), _card_used(torch)
    parent = session.spawn("fleet", "deploy", "--engine-dir", engine_dir, "--device", device, "--ip", "127.0.0.1",
                           "--port", str(port), "--registry-dir", registry, "--fleet", "2", "--fleet-max", "2",
                           "--autoscale", "--cpu-fallback-max", "1", "--autoscale-interval", "0.5",
                           "--fleet-probe-interval", "0.3", "--obs-dir", obs,
                           "--profile-dir", os.path.join(work, "profiles"))

    def replicas() -> list:
        if parent.poll() is not None:
            raise AssertionError(f"the fleet parent exited {parent.returncode}: {session.err('fleet')}")
        return _http(base + "/")[1]["replicas"]

    def ready(p: int) -> bool:
        try:
            return _http(f"http://127.0.0.1:{p}/", timeout=2)[0] == 200
        except (urllib.error.URLError, ConnectionError, TimeoutError, http.client.HTTPException):
            return False

    def healthy(p: int) -> bool:
        try:
            return any(r["url"].endswith(f":{p}") and r["healthy"] for r in replicas())
        except (urllib.error.URLError, ConnectionError, TimeoutError, http.client.HTTPException):
            return False

    passed = False
    try:
        t0 = time.perf_counter()
        _wait(lambda: all(ready(p) and healthy(p) for p in (port + 1, port + 2)), 300, "the fleet's two workers")
        steps["boot_s"] = time.perf_counter() - t0
        pids = {name: _pid_on_port(p) for name, p in (("w0", port + 1), ("w1", port + 2))}
        # 1. the gateway's hop: the same queries through it and straight to w0
        users = [f"u{u}" for u in rng.integers(0, n_users, n_queries)]
        shares0 = _forwards_by_replica(base)
        t_traffic = time.perf_counter()
        via, via_wall = _fleet_query_run(port, users, clients)
        shares = {k: v - shares0.get(k, 0.0) for k, v in _forwards_by_replica(base).items()}
        direct, direct_wall = _fleet_query_run(port + 1, users, clients)
        _fleet_answers_held(models[v1], via, "through the gateway")
        _fleet_answers_held(models[v1], direct, "straight to w0")
        steps.update(gateway_p50_ms=_p50_ms([o[3] for o in via]), gateway_qps=n_queries / via_wall,
                     direct_p50_ms=_p50_ms([o[3] for o in direct]), direct_qps=n_queries / direct_wall,
                     replica_share={k: v / n_queries for k, v in sorted(shares.items())})
        steps["hop_p50_ms"] = steps["gateway_p50_ms"] - steps["direct_p50_ms"]
        # 2. one CUDA context each device worker
        images = {name: _worker_images(pid) for name, pid in pids.items()}
        apps = _compute_apps()
        if any(not im["cuda_context"] or im["foreign_images"] or "predictionio_tpu_torch.tools.cli" not in im["argv"]
               for im in images.values()) or len(apps) < len(apps0) + 2:
            raise AssertionError(f"device workers: {images}; compute apps {apps0} -> {apps}")
        steps["compute_apps"] = apps
        steps["worker_card_bytes"] = (_card_used(torch) - used0) / 2
        # 3. SIGKILL w0 amid traffic
        statuses: list = []
        stop = threading.Event()
        answered: list = []

        def pump():
            conn = _Conn(port)
            k = 0
            try:
                while not stop.is_set():
                    u = f"u{(k * 7919) % n_users}"
                    k += 1
                    try:
                        status, _, body, dt = conn.call("POST", "/queries.json", {"user": u, "num": 10})
                    except (OSError, ValueError) as exc:
                        statuses.append(type(exc).__name__)
                        conn.close()
                        conn = _Conn(port)
                        continue
                    statuses.append(status)
                    answered.append((u, status, body, dt))
            finally:
                conn.close()

        pumps = [threading.Thread(target=pump, daemon=True) for _ in range(8)]
        for t in pumps:
            t.start()
        time.sleep(1.0)
        t_kill = time.perf_counter()
        os.kill(pids["w0"], signal.SIGKILL)
        try:
            steps["kill_to_restart_s"] = _wait(
                lambda: _pid_on_port(port + 1) not in (None, pids["w0"]) and ready(port + 1), 300, "w0's restart")
            _wait(lambda: healthy(port + 1), 60, "w0's readmission")
            steps["kill_to_readmit_s"] = time.perf_counter() - t_kill
            time.sleep(0.5)
        finally:
            stop.set()
            for t in pumps:
                t.join(timeout=60)
        if set(statuses) != {200}:
            raise AssertionError(f"answers around the kill: {sorted(set(map(str, statuses)))}")
        _fleet_answers_held(models[v1], answered, "around the kill")
        steps["queries_around_kill"] = len(statuses)
        pids["w0"] = _pid_on_port(port + 1)
        crashes = [b for b in list_bundles(os.path.join(obs, "incidents")) if b.trigger == "worker-crash"]
        if not crashes:
            raise AssertionError(f"no worker-crash bundle: {os.listdir(os.path.join(obs, 'incidents'))}")
        bundle = load_bundle(os.path.join(obs, "incidents"), crashes[0].bundle_id)
        if bundle["manifest"]["context"].get("replica") != "w0" or "deployed at" not in \
                bundle["texts"].get("stderr_tail", ""):
            raise AssertionError(f"the crash bundle: {bundle['manifest']}")
        # 4. overflow into the cpu-fallback class
        def cpu_replica():
            return next((r for r in replicas() if r["workerClass"] == "cpu-fallback" and r["healthy"]), None)

        steps["cpu_fallback_before_flood"] = cpu_replica() is not None
        stop.clear()
        flood_statuses: list = []

        def flood():
            conn = _Conn(port)
            k = 0
            try:
                while not stop.is_set():
                    k += 1
                    status, _, _, _ = conn.call("POST", "/queries.json", {"user": f"u{k % n_users}", "num": 10})
                    flood_statuses.append(status)
            finally:
                conn.close()

        floods = [threading.Thread(target=flood, daemon=True) for _ in range(flood_clients)]
        used_before_flood = _card_used(torch)
        t_flood = time.perf_counter()
        for t in floods:
            t.start()
        try:
            _wait(lambda: cpu_replica() is not None, 60, "a cpu-fallback replica")
            steps["flood_to_cpu_fallback_s"] = time.perf_counter() - t_flood
            steps["traffic_to_cpu_fallback_s"] = time.perf_counter() - t_traffic
            time.sleep(0.5)
        finally:
            stop.set()
            for t in floods:
                t.join(timeout=60)
        if set(flood_statuses) != {200}:
            raise AssertionError(f"flood answers: {sorted(set(flood_statuses))}")
        cpu_port = int(cpu_replica()["url"].rsplit(":", 1)[1])
        cpu_pid = _pid_on_port(cpu_port)
        cpu_out, _ = _fleet_query_run(cpu_port, users[:64], 4)
        _fleet_answers_held(models[v1], cpu_out, "the cpu-fallback replica")
        cpu_image = _worker_images(cpu_pid)
        metrics = parse_metrics(_get(base, "/metrics")[2])
        overflow = sum(v for _, v, _ in metrics.get("pio_fleet_overflow_picks_total", []))
        apps = _compute_apps()
        if cpu_image["cuda_context"] or cpu_image["foreign_images"] or "--device" not in cpu_image["argv"] \
                or cpu_image["argv"][cpu_image["argv"].index("--device") + 1] != "cpu" or len(apps) != len(apps0) + 2:
            raise AssertionError(f"the cpu-fallback worker: {cpu_image}; compute apps {apps}")
        steps.update(flood_queries=len(flood_statuses), overflow_picks=overflow, cpu_fallback_port=cpu_port,
                     card_bytes_across_flood=_card_used(torch) - used_before_flood)
        # 5. a rollout through the gateway reaches every worker
        ports = [port + 1, port + 2, cpu_port]

        def on_every_worker(pred) -> bool:
            return all(pred(_http(f"http://127.0.0.1:{p}/models")[1]) for p in ports)

        if _http(base + "/models/candidate", {"version": v2, "fraction": 0.1})[0] != 200:
            raise AssertionError("staging through the gateway failed")
        steps["stage_adopted_s"] = _wait(lambda: on_every_worker(
            lambda m: (m["candidate"] or {}).get("version") == v2), 120, "every worker's canary")
        if _http(base + "/models/promote", {})[0] != 200:
            raise AssertionError("the promote through the gateway failed")
        steps["promote_adopted_s"] = _wait(lambda: on_every_worker(
            lambda m: m["stable"]["version"] == v2 and m["candidate"] is None), 3.0, "every worker's new stable")
        promoted, _ = _fleet_query_run(port, users[:256], clients)
        _fleet_answers_held(models[v2], promoted, "after the promote")
        # 6. pio top --fleet
        out, _ = session.run("top_fleet", "top", "--fleet", "--once", "--json", "--url", base)
        fleet_line = json.loads(out.strip().splitlines()[-1])["fleet"]
        if fleet_line["replicas_total"] != 3 or fleet_line["replicas_up"] != 3 or fleet_line["restarts_total"] < 1:
            raise AssertionError(f"pio top's fleet line: {fleet_line}")
        steps["top_fleet"] = {k: fleet_line[k] for k in ("replicas_total", "replicas_up", "restarts_total",
                                                         "retries_total", "no_replica_total")}
        # 7. SIGTERM: a zero-downtime stop
        workers = [pids["w0"], pids["w1"], cpu_pid]
        t_term = time.perf_counter()
        parent.send_signal(signal.SIGTERM)
        code = parent.wait(timeout=60)
        steps["sigterm_exit_s"] = time.perf_counter() - t_term
        if code != 0 or steps["sigterm_exit_s"] > 20.0:
            raise AssertionError(f"the fleet parent exited {code} {steps['sigterm_exit_s']} s after SIGTERM")
        _wait(lambda: not any(os.path.exists(f"/proc/{p}") for p in workers) and len(_compute_apps()) == len(apps0),
              30, "the workers leaving the card")
        passed = True
    finally:
        if not passed:
            emit(phase="fleet_cli_failed", steps=steps, ring=_ring_summary(obs))
            for p in (port + 1, port + 2, port + 3):
                pid = _pid_on_port(p)
                if pid is not None:
                    os.kill(pid, signal.SIGKILL)
        session.stop_all()
    session.foreign()
    with open(parent.report) as fh:
        parent_launches = json.load(fh)["launches"]
    remove_work(work)
    steps.update(host_numbers=True, queries=n_queries, clients=clients, flood_clients=flood_clients,
                 parent_launches=parent_launches)
    emit_numbers("fleet_cli", **steps)
    return steps


@phase
def fleet_lifecycle_cli_phase(torch, home: str, rest: dict, reg: dict, device: str = "cuda") -> dict:
    """The lifecycle controller in the fleet parent, on the ML-100K store
    lifecycle_cli used, in its directory after it: ``pio deploy --fleet 2
    --lifecycle lifecycle_grid.make_evaluation --lifecycle-app restapp
    --lifecycle-workers 0 --lifecycle-warm-limit 8 --no-auto-promote``
    over lifecycle_cli's registry and a fresh obs dir. One drift line on
    the fleet's ring starts the episode: the retune's cells train in the
    parent, every one on the CPU (no B1 launch in the parent), the winner
    lands as the canary both workers adopt, a promote through the gateway
    ends the bake, and the controller sends at most 8 warm queries through
    the gateway; the same queries sent again through the gateway are all
    cache hits, summed over the workers' /metrics. SIGTERM: exit 0."""
    import re

    from predictionio_tpu_torch.data.store.event_store import resolve_app
    from predictionio_tpu_torch.lifecycle import read_json_file
    from predictionio_tpu_torch.obs.tsring import TelemetryRing
    from predictionio_tpu_torch.registry import ArtifactStore
    from predictionio_tpu_torch.workflow.batch_predict import iter_event_users

    work, engine_dir, registry = reg["work"], reg["engine_dir"], reg["registry"]
    engine_id = reg["variant"]["id"]
    obs = os.path.join(work, "fleet_obs")
    train_log = os.path.join(work, "fleet_trains.log")
    env = {**os.environ, "PYTHONPATH": os.path.dirname(os.path.abspath(__file__)), "GRID_TRAIN_LOG": train_log}
    session = _CliSession(work, home, env)
    store = ArtifactStore(registry)
    stable0 = store.get_state(engine_id).stable
    if store.get_state(engine_id).candidate:
        raise AssertionError(f"a candidate is staged: {store.get_state(engine_id).to_json_dict()}")
    state_path = os.path.join(obs, "lifecycle", "lifecycle.json")
    port = _fleet_ports(3)
    base = f"http://127.0.0.1:{port}"
    steps: dict = {}
    parent = session.spawn("fleet_lifecycle", "deploy", "--engine-dir", engine_dir, "--device", device,
                           "--ip", "127.0.0.1", "--port", str(port), "--registry-dir", registry, "--fleet", "2",
                           "--obs-dir", obs, "--fleet-probe-interval", "0.3", "--registry-sync-interval", "0.2",
                           "--no-auto-promote", "--lifecycle", "lifecycle_grid.make_evaluation",
                           "--lifecycle-workers", "0", "--lifecycle-app", "restapp", "--lifecycle-warm-limit", "8",
                           "--profile-dir", os.path.join(work, "fleet_profiles"))

    def state() -> dict:
        if parent.poll() is not None:
            raise AssertionError(f"the fleet parent exited {parent.returncode}: {session.err('fleet_lifecycle')}")
        return (read_json_file(state_path) or {}).get("policy", {})

    def ready() -> bool:
        state()
        try:
            for p in (port + 1, port + 2):
                _http(f"http://127.0.0.1:{p}/", timeout=2)
            return _http(base + "/healthz", timeout=2)[1]["replicasHealthy"] == 2
        except (urllib.error.URLError, ConnectionError, TimeoutError, http.client.HTTPException):
            return False

    def on_both(pred) -> bool:
        return all(pred(_http(f"http://127.0.0.1:{p}/models")[1]) for p in (port + 1, port + 2))

    def cache_hits() -> float:
        return sum(_queries_total(f"http://127.0.0.1:{p}", "pio_cache_hits_total") for p in (port + 1, port + 2))

    passed = False
    try:
        steps["boot_s"] = _wait(ready, 300, "the fleet's two workers")
        TelemetryRing(os.path.join(obs, "telemetry"), writer_id="stream").append({
            "kind": "drift", "engine": engine_id, "trainer": "als", "guard": "holdout_rmse",
            "measured": 9.9, "threshold": 0.5, "reason": "a breach"})
        t0 = time.perf_counter()
        _wait(lambda: state().get("state") == "baking", 600, "the grid's winner baking")
        steps["drift_to_baking_s"] = time.perf_counter() - t0
        winner = store.get_state(engine_id).candidate
        steps["canary_adopted_s"] = _wait(lambda: on_both(
            lambda m: (m["candidate"] or {}).get("version") == winner), 120, "both workers' canary")
        if _http(base + "/models/promote", {})[0] != 200:
            raise AssertionError("the promote through the gateway failed")
        _wait(lambda: state().get("state") == "idle", 120, "the episode closing")
        steps["drift_to_idle_s"] = time.perf_counter() - t0
        final = read_json_file(state_path)
        if final["policy"]["lastOutcome"] != "promoted" or final["lastDecision"]["action"] != "warm" \
                or store.get_state(engine_id).stable != winner:
            raise AssertionError(f"episode: {final}; registry {store.get_state(engine_id).to_json_dict()}")
        _wait(lambda: "cache warmed for" in session.err("fleet_lifecycle"), 30, "the warm's log line")
        warm = re.findall(r"cache warmed for (\S+): \{'ok': (\d+), 'error': (\d+)\}", session.err("fleet_lifecycle"))
        if len(warm) != 1 or warm[0][0] != winner or int(warm[0][2]) or not 0 < int(warm[0][1]) <= 8:
            raise AssertionError(f"the warm: {warm}\n{session.err('fleet_lifecycle')}")
        warmed = int(warm[0][1])
        levents = smoke_storage(home).get_l_events()
        app_id, _ = resolve_app(smoke_storage(home), "restapp", None)
        hits0 = cache_hits()
        queries = [q for _, q in iter_event_users(levents, app_id, limit=8)]
        for q in queries:
            if _http(base + "/queries.json", q)[0] != 200:
                raise AssertionError(f"warm query {q} not answered 200")
        hits = cache_hits() - hits0
        devices = sorted({ln.split()[1] for ln in _lines(train_log)})
        if hits != warmed or len(queries) != warmed or devices != ["cpu"]:
            raise AssertionError(f"{hits} cache hits of {warmed} warmed ({len(queries)} queries); cells on {devices}")
        ring = [r.get("event") for r in TelemetryRing(os.path.join(obs, "telemetry")).records()
                if r.get("kind") == "lifecycle"]
        if ring != ["triggered", "tuning", "baking", "finished"]:
            raise AssertionError(f"ring: {ring}")
        parent.send_signal(signal.SIGTERM)
        if parent.wait(timeout=60) != 0:
            raise AssertionError(f"the fleet parent exited {parent.returncode}")
        passed = True
    finally:
        if not passed:
            for p in (port + 1, port + 2):
                pid = _pid_on_port(p)
                if pid is not None:
                    os.kill(pid, signal.SIGKILL)
        session.stop_all()
    session.foreign()
    with open(parent.report) as fh:
        launches = json.load(fh)["launches"]
    if launches.get("spd_cg"):
        raise AssertionError(f"the retune's cells launched B1 on the card: {launches}")
    cells = len(_lines(train_log))
    remove_work(work)
    result = {"host_numbers": True, **steps, "stable_before": stable0, "winner": winner,
              "cells": cells, "cell_devices": devices, "warm_queries": warmed,
              "warm_cache_hits": hits, "parent_spd_cg_launches": launches.get("spd_cg", 0)}
    emit(phase="fleet_lifecycle_cli", **result)
    return result


def profiled_train(work: str, run, reports: list, engine_dir: str, device: str) -> int:
    """``pio profile train`` of the ML-100K retrain: its bundle's
    torch.profiler trace holds B1's register-plan kernel
    (``spd_cg_registers``) exactly as often as the wrapper counted its
    launches, both in the process's report and over the trace's window
    (``launchesCounted``). Returns the launches."""
    from predictionio_tpu_torch.obs.profiler import ProfileStore, kernel_launches, trace_kernels

    prof_dir = os.path.join(work, "train_profiles")
    t0 = time.perf_counter()
    run("profile", "train", "--profile-dir", prof_dir, "--", "--engine-dir", engine_dir, "--device", device)
    wall = time.perf_counter() - t0
    with open(reports[-1]) as fh:
        counted = json.load(fh)["launches"]["spd_cg"]
    (ref,) = ProfileStore(prof_dir).list()
    with open(os.path.join(ref.path, "manifest.json")) as fh:
        manifest = json.load(fh)
    kernels = trace_kernels(os.path.join(ref.path, "trace"))
    traced = kernel_launches(kernels, "spd_cg_registers")
    window = manifest["context"].get("launchesCounted", {}).get("spd_cg")
    if not counted or traced != counted or window != counted:
        raise AssertionError(f"profiled train: B1 counted {counted} (window {window}), traced {traced}: "
                             f"{sorted(kernels.items(), key=lambda kv: -kv[1])[:8]}")
    emit_numbers("profile_train", spd_cg_launches_counted=counted, spd_cg_registers_traced=traced,
                 kernel_events=sum(kernels.values()), distinct_kernels=len(kernels), wall_s=wall,
                 trace_bytes=sum(e["bytes"] for e in manifest["trace"]))
    return counted


def _seq_pump(base: str, sessions, stop: threading.Event) -> list:
    """One client sending distinct session windows, one at a time, while
    the server reports a capture window open (``profiling.capturing``),
    until ``stop``; returns the statuses. So every launch falls inside the
    window the wrapper's count covers, and at most one query is under way
    at either edge."""
    statuses, n = [], 0
    while not stop.is_set():
        if not _http(base + "/")[1]["profiling"]["capturing"]:
            time.sleep(0.002)
            continue
        tail = sessions[n % len(sessions)][-(5 + n % 40):]
        status, _, _ = _http(base + "/queries.json", {"recentItems": [f"i{i}" for i in tail], "num": 10})
        statuses.append(status)
        n += 1
    return statuses


def sequential_captures(cli, env, engine_dir: str, work: str, device: str, sessions) -> dict:
    """The trained attention model deployed twice more from variants at
    context 200 (B2) and 1024 (B3); while each answers queries, ``pio
    profile serve --ms 500`` captures it and ``pio profile show`` lists the
    trace's kernels: the wrapper's symbol (``attention_block_kernel`` /
    ``flash_attention_kernel``) appears within 1 of the launches the
    wrapper counted over the capture's window (one client queries only
    while that window is open); the two servers are captured at the same
    time. A capture POSTed during the first answers 409."""
    with open(os.path.join(engine_dir, "engine.json")) as fh:
        variant = json.load(fh)
    servers, out = {}, {}
    try:
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            futs = {}
            for context, kernel in ((200, "attention_block"), (1024, "flash_attention")):
                # the same engine id, version and variant name: the deploy
                # finds the trained instance and serves at this context
                ctx_dir = os.path.join(work, f"engine_{context}")
                os.makedirs(ctx_dir)
                with open(os.path.join(ctx_dir, "engine.json"), "w") as fh:
                    json.dump({**variant, "algorithms": [{"name": "attention", "params": {
                        **variant["algorithms"][0]["params"], "context": context}}]}, fh)
                prof = os.path.join(work, f"profiles_{context}")
                futs[context] = (kernel, prof, pool.submit(
                    _start_deploy, cli, env, ctx_dir, work, device, name=f"deploy_{context}",
                    extra=("--profile-dir", prof)))
            for context, (kernel, prof, fut) in futs.items():
                servers[context] = (kernel, prof, *fut.result())

        def capture(context):
            kernel, prof, server, base, ready_s = servers[context]
            stop = threading.Event()
            pumped = concurrent.futures.ThreadPoolExecutor(1).submit(_seq_pump, base, sessions, stop)
            conflict = []
            poker = threading.Thread(target=_conflicting_capture, args=(base, conflict))
            if context == 200:
                poker.start()
            t0 = time.perf_counter()
            try:
                proc = subprocess.run([*cli, "profile", "serve", "--url", base, "--ms", "500"], env=env,
                                      capture_output=True, text=True, timeout=120)
            finally:
                stop.set()
            serve_s = time.perf_counter() - t0
            statuses = pumped.result(60)
            if context == 200:
                poker.join(30)
                if conflict != [409]:
                    raise AssertionError(f"a capture during a capture answered {conflict}")
            if proc.returncode != 0 or any(st != 200 for st in statuses):
                raise AssertionError(f"profile serve at context {context}: {proc.returncode} {proc.stderr[-2000:]}")
            body = json.loads(proc.stdout)
            show = subprocess.run([*cli, "profile", "show", body["bundle"], "--profile-dir", prof], env=env,
                                  capture_output=True, text=True, timeout=120)
            symbol = f"{kernel}_kernel"
            traced = sum(int(line.split()[1]) for line in show.stdout.splitlines()
                         if line.startswith("kernel ") and f"::{symbol}<" in line)
            counted = body["launchesCounted"][kernel]
            if show.returncode != 0 or not counted or abs(traced - counted) > 1:
                raise AssertionError(f"context {context}: {symbol} traced {traced}, counted {counted}:\n"
                                     f"{show.stdout[-3000:]}")
            out[context] = {"kernel": symbol, "traced": traced, "counted": counted, "queries": len(statuses),
                            "profile_serve_s": serve_s, "deploy_ready_s": ready_s,
                            "kernel_events": sum(body["kernels"].values())}

        # the two servers are separate processes, each with its own profiler
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            for done in [pool.submit(capture, context) for context in servers]:
                done.result()
    finally:
        for _, _, server, *_ in servers.values():
            _stop(server)
    for context, row in sorted(out.items()):
        emit_numbers(f"sequential_capture_{context}", **{k: v for k, v in row.items() if k != "kernel"})
    return out


class _CliSession:
    """The port's CLI verbs of one phase, each a process started through
    _CLI_LAUNCHER in ``work`` on the store of ``--home home``; every report
    file is kept in :attr:`reports`, every wall time in :attr:`steps`, every
    server in :attr:`procs`."""

    def __init__(self, work: str, home: str, env: dict):
        self.work, self.home, self.env = work, home, env
        self.reports: list[str] = []
        self.steps: dict = {}
        self.procs: list = []
        self._lock = threading.Lock()  # verbs may run from several threads
        self.started: dict = {}  # server verbs by name

    def argv(self, *args) -> tuple[list[str], str]:
        """The launcher's command line for a verb, and its report file."""
        with self._lock:
            report = os.path.join(self.work, f"report_{len(self.reports)}.json")
            self.reports.append(report)
        return [sys.executable, "-c", _CLI_LAUNCHER, report, "--home", self.home, *args], report

    def run(self, name: str, *args, timeout: float = 600):
        """Run one verb to its end: (stdout, the launch counts)."""
        t0 = time.perf_counter()
        argv, report = self.argv(*args)
        proc = subprocess.run(argv, env=self.env, capture_output=True, text=True, timeout=timeout, cwd=self.work)
        if proc.returncode != 0:
            raise AssertionError(f"cli {' '.join(args[:2])} failed ({proc.returncode}):\n{proc.stderr[-3000:]}")
        self.steps[f"{name}_s"] = time.perf_counter() - t0
        with open(report) as fh:
            return proc.stdout, json.load(fh)["launches"]

    def spawn(self, name: str, *args, env: dict | None = None):
        """Start a verb that runs until stopped (stderr to name.err); the
        process gets its report file's path as ``report``."""
        argv, report = self.argv(*args)
        with open(os.path.join(self.work, f"{name}.err"), "w") as err:
            proc = subprocess.Popen(argv, env=env or self.env, stdout=subprocess.DEVNULL, stderr=err, cwd=self.work)
        proc.report = report
        self.procs.append(proc)
        return proc

    def err(self, name: str) -> str:
        with open(os.path.join(self.work, f"{name}.err")) as fh:
            return fh.read()[-3000:]

    def start(self, name: str, *args) -> str:
        """Start a server verb on a free port; its base URL once GET /
        answers 200."""
        port = _free_port()
        proc = self.spawn(name, *args, "--ip", "127.0.0.1", "--port", str(port))
        self.started[name] = proc
        t0 = time.perf_counter()
        while True:
            if proc.poll() is not None:
                raise AssertionError(f"{name} exited {proc.returncode}: {self.err(name)}")
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=2) as resp:
                    if resp.status == 200:
                        self.steps[f"{name}_ready_s"] = time.perf_counter() - t0
                        return f"http://127.0.0.1:{port}"
            except (urllib.error.URLError, ConnectionError, TimeoutError):
                pass
            if time.perf_counter() - t0 > 180:
                raise AssertionError(f"{name} did not answer GET / within 180 s")
            time.sleep(0.2)

    def stop_all(self) -> None:
        for proc in self.procs:
            if proc.poll() is None:
                _stop(proc)

    def foreign(self, skip=()) -> None:
        """Fail if a process imported JAX, the JAX package or aiohttp."""
        for path in self.reports:
            if path in skip:
                continue
            with open(path) as fh:
                foreign = json.load(fh)["foreign_modules"]
            if foreign:
                raise AssertionError(f"{os.path.basename(path)}: imported {foreign[:5]}")


@phase
def registry_cli_phase(torch, home: str, rest: dict, device: str = "cuda", n_new_users: int = 500,
                       n_new: int = 5_000) -> dict:
    """The registry path as a user drives it, each verb a process of the
    port's CLI on the event server's ML-100K store: train --registry-dir
    (v000001 stable), models list, deploy --registry-dir
    --registry-sync-interval 0.5, stream --cycles 1 (seeds its cursor at
    the store head), 5,000 more rate events through POST
    /batch/events.json (by 500 new users, each rating as an existing user
    would under the trained model), stream --cycles 3 --notify-url
    (B1 twice per absorb, one candidate staged on the server), 200 queries
    answered 200 (some by the candidate), models promote and rollback on
    the registry (the server adopts both), eval --publish (its winner
    lands as the candidate, the server adopts it). No process imports
    JAX, the JAX package or aiohttp."""
    import datetime as dt

    from predictionio_tpu_torch.workflow import model_io

    work = work_dir(prefix="pio_smoke_registry_")
    # the reference's variable: every version this path trains pins an index
    env = {**os.environ, "PYTHONPATH": os.path.dirname(os.path.abspath(__file__)), "PIO_ANN_MIN_ITEMS": "0"}
    session = _CliSession(work, home, env)
    run, start, steps = session.run, session.start, session.steps

    def models_state(base):
        with urllib.request.urlopen(base + "/models", timeout=30) as resp:
            return json.loads(resp.read())

    def wait_for(base, what, check):
        t0 = time.perf_counter()
        while not check(models_state(base)):
            if time.perf_counter() - t0 > 60:
                raise AssertionError(f"the server never adopted {what}: {models_state(base)}")
            time.sleep(0.1)
        return time.perf_counter() - t0

    registry = os.path.join(work, "registry")
    variant = {**rest["variant"], "id": "smoke-registry"}
    engine_dir = os.path.join(work, "engine")
    os.makedirs(engine_dir)
    with open(os.path.join(engine_dir, "engine.json"), "w") as fh:
        json.dump(variant, fh)
    ed = ["--engine-dir", engine_dir, "--device", device]
    launches = {}
    try:
        _, counts = run("train", "train", *ed, "--registry-dir", registry)
        launches["train"] = counts["spd_cg"]
        from predictionio_tpu_torch.registry import ArtifactStore

        store = ArtifactStore(registry)
        indexes = {"v000001": store.get_manifest("smoke-registry", "v000001").ann_index}
        if (indexes["v000001"] or {}).get("builtFrom") != "train":
            raise AssertionError(f"train --registry-dir pinned no index: {indexes}")
        stream = ["stream", *ed, "--app-name", "restapp", "--registry-dir", registry,
                  "--batch-limit", "500", "--interval", "1", "--fraction", "0.5"]
        # models list and the seeding stream (a fresh cursor starts at the
        # store head) run beside the deploy's boot
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            listed = pool.submit(run, "models_list", "models", "list", "--engine-dir", engine_dir,
                                 "--registry-dir", registry)
            seeded = pool.submit(run, "stream_seed", *stream, "--cycles", "1")
            base = start("deploy", "deploy", *ed, "--registry-dir", registry, "--registry-sync-interval", "0.5",
                         "--bake-window", "3600")
            stdout, _ = listed.result()
            seeded.result()
        if not any(line.startswith("v000001") and "stable" in line for line in stdout.splitlines()):
            raise AssertionError(f"models list:\n{stdout}")
        if models_state(base)["stable"]["version"] != "v000001":
            raise AssertionError("deploy does not serve the registry's stable")
        (model,) = model_io.deserialize_models(store.load_blob("smoke-registry", "v000001"))
        rng = np.random.default_rng(37)
        events = _rating_events(model, rng, np.zeros(0, np.int64), [f"cli-new{j}" for j in range(n_new_users)],
                                rng.integers(0, len(model.user_vocab), n_new_users), n_new,
                                dt.datetime.now(tz=dt.timezone.utc))
        es = start("eventserver", "eventserver")
        key = rest["access_key"]
        t0 = time.perf_counter()
        for lo in range(0, len(events), 50):
            status, results, _ = _http(f"{es}/batch/events.json?accessKey={key}",
                                       [{k: v for k, v in e.to_json_dict().items() if k != "eventId"}
                                        for e in events[lo:lo + 50]])
            if status != 200 or any(r.get("status") != 201 for r in results):
                raise AssertionError(f"batch at {lo}: {status} {results[:2]}")
        steps["post_events_s"] = time.perf_counter() - t0
        time.sleep(1.0)  # past the stream's safety lag
        obs = os.path.join(work, "obs")
        stdout, counts = run("stream", *stream, "--cycles", "3", "--notify-url", base, "--obs-dir", obs)
        launches["stream"] = counts["spd_cg"]
        absorbs = -(-len(events) // 500)
        if launches["stream"] != 2 * absorbs or "1 published" not in stdout:
            raise AssertionError(f"pio stream: {launches['stream']} B1 launches for {absorbs} absorbs:\n{stdout}")
        state = store.get_state("smoke-registry")
        cand = state.candidate
        if not cand or models_state(base)["candidate"]["version"] != cand:
            raise AssertionError(f"the streamed candidate was not staged on the server: {state.to_json_dict()}")
        indexes[cand] = store.get_manifest("smoke-registry", cand).ann_index
        if (indexes[cand] or {}).get("builtFrom") not in ("refresh", "rebuild") \
                or store.load_ann_blob("smoke-registry", cand) is None:
            raise AssertionError(f"pio stream's candidate carries no refreshed index: {indexes}")
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            outs = list(pool.map(lambda u: _query(base, {"user": u, "num": 10}),
                                 [u for u in rest["user_ids"] if u.startswith("u")][:200]))
        if any(status != 200 for status, _, _, _ in outs):
            raise AssertionError("a query was not answered 200")
        by_version = {v: sum(1 for _, _, w, _ in outs if w == v) for v in {w for _, _, w, _ in outs}}
        if set(by_version) != {"v000001", cand}:
            raise AssertionError(f"answers by version {by_version}")
        for status, body, _, _ in outs[:50]:
            _check_result(body, 10, 1682)
        run("models_promote", "models", "promote", "--engine-dir", engine_dir, "--registry-dir", registry)
        steps["adopt_promote_s"] = wait_for(base, "the promote", lambda s: s["stable"]["version"] == cand)
        run("models_rollback", "models", "rollback", "--engine-dir", engine_dir, "--registry-dir", registry)
        steps["adopt_rollback_s"] = wait_for(base, "the rollback",
                                             lambda s: s["stable"]["version"] == "v000001")
        with open(os.path.join(work, "registry_grid.py"), "w") as fh:
            fh.write(_REGISTRY_GRID.format(variant={**variant, "datasource": {"params": {
                **variant["datasource"]["params"], "evalParams": {"kFold": 2, "queryNum": 10}}}}))
        stdout, counts = run("eval_publish", "eval", "registry_grid.make_evaluation", "--device", device,
                             "--workers", "0", "--workdir", os.path.join(work, "grid"),
                             "--engine-dir", engine_dir, "--registry-dir", registry, "--publish")
        launches["eval_publish"] = counts["spd_cg"]
        winner = store.get_state("smoke-registry").candidate
        if f"candidate {winner}" not in stdout or not store.get_manifest("smoke-registry", winner).eval_evidence:
            raise AssertionError(f"eval --publish landed no candidate:\n{stdout}")
        steps["adopt_winner_s"] = wait_for(base, "the grid winner", lambda s: (s["candidate"] or {}).get("version") == winner)
        steps.update(stream_drift(run, stream, es, key, model, obs))
    finally:
        session.stop_all()
    session.foreign()
    if launches["train"] != 20 or launches["eval_publish"] != (4 + 1) * 20:
        raise AssertionError(f"B1 launches {launches}")
    result = {"host_numbers": True, **steps, "spd_cg_launches": launches, "streamed_events": len(events),
              "answers_by_version": by_version, "candidate": cand, "grid_winner": winner,
              "ann_indexes": indexes}
    emit(phase="registry_cli", **result)
    # lifecycle_cli goes on in this directory (its registry, engine, obs dir)
    return {"launches": {"registry_cli": sum(launches.values())}, "work": work, "engine_dir": engine_dir,
            "registry": registry, "obs": obs, "variant": variant}


def stream_drift(run, stream: list, es: str, key: str, model, obs: str, n_events: int = 900) -> dict:
    """``pio stream --obs-dir``'s drift signal: 900 ratings by existing
    users drawn with replacement from the first 900 (each re-solved from
    its one or few stream ratings regresses, and a held-out rating of a
    re-solved user shows it, so the drift guard suppresses the publish, as
    tests/test_torch_stream.py shows in both packages; a rating each by 900
    distinct users would hold out only untouched users) through POST
    /batch/events.json, then ``pio stream --cycles 1 --obs-dir``: a
    ``kind="drift"`` line on the telemetry ring and a ``stream-drift``
    bundle that ``pio incidents list`` reads."""
    import datetime as dt

    from predictionio_tpu_torch.obs.tsring import TelemetryRing

    rng = np.random.default_rng(41)
    events = _rating_events(model, rng, rng.integers(0, n_events, n_events), ["none"], np.zeros(1, np.int64), 0,
                            dt.datetime.now(tz=dt.timezone.utc))
    for lo in range(0, len(events), 50):
        status, results, _ = _http(f"{es}/batch/events.json?accessKey={key}",
                                   [{k: v for k, v in e.to_json_dict().items() if k != "eventId"}
                                    for e in events[lo:lo + 50]])
        if status != 200 or any(r.get("status") != 201 for r in results):
            raise AssertionError(f"drift batch at {lo}: {status} {results[:2]}")
    time.sleep(1.0)  # past the stream's safety lag
    stdout, _ = run("stream_drift", *stream, "--cycles", "1", "--obs-dir", obs)
    drift = [r for r in TelemetryRing(os.path.join(obs, "telemetry"), writer_id="stream").records()
             if r.get("kind") == "drift"]
    listed, _ = run("incidents_list", "incidents", "list", "--obs-dir", obs)
    if len(drift) != 1 or "stream-drift" not in listed:
        raise AssertionError(f"the drift signal: ring {drift}, stream:\n{stdout}\nincidents:\n{listed}")
    emit_numbers("stream_obs_dir", ring_drift_lines=len(drift), drift_measured=drift[0]["measured"],
                 drift_threshold=drift[0]["threshold"], incident_bundles=listed.count("stream-drift"))
    return {"drift_signal": {k: drift[0][k] for k in ("guard", "measured", "threshold")}}


_REGISTRY_GRID = """
from predictionio_tpu_torch.eval import Evaluation
from predictionio_tpu_torch.models.recommendation.engine import engine_factory
from predictionio_tpu_torch.tuning.metrics import PrecisionAtK

VARIANT = {variant!r}


def make_evaluation():
    engine = engine_factory()
    params = [engine.engine_params_from_variant({{**VARIANT, "algorithms": [{{"name": "als", "params": {{
        **VARIANT["algorithms"][0]["params"], "rank": rank}}}}]}}) for rank in (10, 20)]
    return Evaluation(engine=engine, metric=PrecisionAtK(k=10), engine_params_generator=params)
"""


# the retune grid of lifecycle_cli: the template's ALS, each train logging
# its rank and device to $GRID_TRAIN_LOG after waiting $GRID_TRAIN_SLEEP s
_LIFECYCLE_GRID = """
import os
import time

from predictionio_tpu_torch.controller.engine import Engine
from predictionio_tpu_torch.eval import Evaluation
from predictionio_tpu_torch.models.recommendation import engine as rec
from predictionio_tpu_torch.tuning.metrics import PrecisionAtK

VARIANT = {variant!r}


class LoggedALS(rec.ALSAlgorithm):
    def train(self, ctx, pd):
        with open(os.environ["GRID_TRAIN_LOG"], "a") as fh:
            fh.write(f"{{self.params.rank}} {{ctx.device}}\\n")
        time.sleep(float(os.environ.get("GRID_TRAIN_SLEEP", "0")))
        return super().train(ctx, pd)


def make_evaluation():
    engine = Engine(rec.DataSource, {{"": rec.Preparator}}, {{"als": LoggedALS}}, {{"": rec.Serving}},
                    query_class=rec.Query)
    params = [engine.engine_params_from_variant({{**VARIANT, "algorithms": [{{"name": "als", "params": {{
        **VARIANT["algorithms"][0]["params"], "rank": rank}}}}]}}) for rank in (10, 20)]
    return Evaluation(engine=engine, metric=PrecisionAtK(k=10), engine_params_generator=params)
"""
LIFECYCLE_CELLS = 4  # 2 ranks x 2 folds


def _lines(path: str) -> list[str]:
    if not os.path.exists(path):
        return []
    with open(path) as fh:
        return [ln for ln in fh.read().splitlines() if ln.strip()]


def _queries_total(base: str, family: str) -> float:
    parsed = parse_metrics(_get(base, "/metrics")[2])
    return sum(v for lab, v, _ in parsed.get(family, []) if lab.get("endpoint", "/queries.json") == "/queries.json")


@phase
def lifecycle_cli_phase(torch, home: str, rest: dict, reg: dict, device: str = "cuda", seed: int = 47,
                        rates: dict | None = None, clients: int = 8, wave: int = 64,
                        max_queries: int = 20_000) -> dict:
    """The lifecycle loop through the port's CLI on the event server's
    ML-100K store, in registry_cli's directory after it: models rollback
    (clears the grid winner it left staged), deploy --registry-dir
    --bandit thompson --bandit-app-name restapp, eventserver, then
    lifecycle run over a 2-rank x 2-fold grid with --workers 0 and
    --obs-dir the directory whose telemetry ring holds the drift line
    stream_drift left: that line alone starts the episode. The controller
    is SIGKILLed after the grid's first ledger line and started again: the
    restarted grid trains only the cells the ledger lacks, plus the
    winner's refit (the cell in flight at the kill is the one retrained),
    every cell on the CPU (the cpu-fallback class). The winner lands as the
    canary; 8 clients query it with their own X-Pio-Trace-Id, and each
    answered user converts with its arm's probability (numpy, fixed seed:
    candidate 0.35, stable 0.10), posted as a reward event through POST
    /batch/events.json, until the bandit promotes; the controller then
    warms the cache with at most 8 queries, which are cache hits
    afterwards. Then lifecycle status (text and --json), trigger, pause,
    resume, top --once --json (the bandit line), top --lifecycle, the
    admin server's /cmd/app and /cmd/models/<engine> (the promoted
    version stable) and the dashboard's panel of the server. Every answer
    200; no process imports JAX, the JAX package or aiohttp."""
    import re
    import uuid

    from predictionio_tpu_torch.data.store.event_store import resolve_app
    from predictionio_tpu_torch.lifecycle import read_json_file
    from predictionio_tpu_torch.obs.tsring import TelemetryRing
    from predictionio_tpu_torch.registry import ArtifactStore
    from predictionio_tpu_torch.workflow.batch_predict import iter_event_users

    rates = rates or {"candidate": 0.35, "stable": 0.10}
    work, engine_dir, registry, obs = reg["work"], reg["engine_dir"], reg["registry"], reg["obs"]
    engine_id = reg["variant"]["id"]
    env = {**os.environ, "PYTHONPATH": os.path.dirname(os.path.abspath(__file__))}
    session = _CliSession(work, home, env)
    run, steps = session.run, session.steps
    store = ArtifactStore(registry)
    state_dir = os.path.join(obs, "lifecycle")
    state_path = os.path.join(state_dir, "lifecycle.json")
    ring_dir = os.path.join(obs, "telemetry")
    drift = [r for r in TelemetryRing(ring_dir).records() if r.get("kind") == "drift"]
    if len(drift) != 1:
        raise AssertionError(f"expected stream_drift's one drift line on the ring: {drift}")
    with open(os.path.join(work, "lifecycle_grid.py"), "w") as fh:
        fh.write(_LIFECYCLE_GRID.format(variant={**reg["variant"], "datasource": {"params": {
            **reg["variant"]["datasource"]["params"], "evalParams": {"kFold": 2, "queryNum": 10}}}}))
    ed = ["--engine-dir", engine_dir]
    logs = [os.path.join(work, "trains1.log"), os.path.join(work, "trains2.log")]
    ctl = ["lifecycle", "run", "lifecycle_grid.make_evaluation", *ed, "--registry-dir", registry,
           "--obs-dir", obs, "--workers", "0", "--tick-interval", "0.2", "--cooldown", "9999",
           "--stage-fraction", "0.1", "--app-name", "restapp", "--warm-limit", "8"]
    rng = np.random.default_rng(seed)
    users = [u for u in rest["user_ids"] if u.startswith("u")]
    killed = []
    try:
        if store.get_state(engine_id).candidate:  # eval --publish's winner
            run("models_rollback", "models", "rollback", *ed, "--registry-dir", registry)
        if store.get_state(engine_id).candidate:
            raise AssertionError(f"a candidate is still staged: {store.get_state(engine_id).to_json_dict()}")
        base = session.start("deploy", "deploy", *ed, "--device", device, "--registry-dir", registry,
                             "--registry-sync-interval", "0.2", "--bake-window", "1", "--bake-min-requests", "20",
                             "--bandit", "thompson", "--bandit-app-name", "restapp",
                             "--profile-dir", os.path.join(work, "profiles"))
        es = session.start("eventserver", "eventserver")
        ctl += ["--serve-url", base]
        t0 = time.perf_counter()
        c1 = session.spawn("lifecycle1", *ctl, env={**env, "GRID_TRAIN_LOG": logs[0], "GRID_TRAIN_SLEEP": "1"})
        killed.append(c1.report)
        ledger = os.path.join(state_dir, "grid", "run-0001", "ledger.jsonl")
        _wait(lambda: c1.poll() is not None or len(_lines(ledger)) >= 1, 600, "the grid's first ledger line")
        if c1.poll() is not None:
            raise AssertionError(f"lifecycle run exited {c1.returncode}: {session.err('lifecycle1')}")
        c1.send_signal(signal.SIGKILL)
        c1.wait(timeout=30)
        steps["drift_to_first_cell_s"] = time.perf_counter() - t0
        finished_at_kill, trains_at_kill = len(_lines(ledger)), len(_lines(logs[0]))
        if (read_json_file(state_path) or {}).get("policy", {}).get("state") != "tuning":
            raise AssertionError(f"state after the kill: {read_json_file(state_path)}")
        c2 = session.spawn("lifecycle2", *ctl, env={**env, "GRID_TRAIN_LOG": logs[1], "GRID_TRAIN_SLEEP": "0"})
        t1 = time.perf_counter()

        def state():
            if c2.poll() is not None:
                raise AssertionError(f"lifecycle run exited {c2.returncode}: {session.err('lifecycle2')}")
            return (read_json_file(state_path) or {}).get("policy", {})

        _wait(lambda: state().get("state") == "baking", 600, "the grid's winner baking")
        steps["restart_to_baking_s"] = time.perf_counter() - t1
        winner = store.get_state(engine_id).candidate
        _wait(lambda: (_http(base + "/")[1]["bandit"] or {}).get("active"), 60, "the bandit engaging")
        port = int(base.rsplit(":", 1)[1])
        answers, conversions, n, t2 = {"stable": 0, "candidate": 0}, {"stable": 0, "candidate": 0}, 0, \
            time.perf_counter()
        while store.get_state(engine_id).stable != winner:
            if n >= max_queries:
                raise AssertionError(f"no bandit promote after {n} queries: {_http(base + '/')[1]['bandit']}")
            batch = [users[i] for i in rng.integers(0, len(users), wave)]
            local, conns = threading.local(), []

            def one(u):
                if not hasattr(local, "conn"):
                    local.conn = _TracedConn(port)
                    conns.append(local.conn)
                tid = uuid.uuid4().hex[:16]
                return (u, tid, *local.conn.query({"user": u, "num": 10}, tid))

            with concurrent.futures.ThreadPoolExecutor(clients) as pool:
                outs = list(pool.map(one, batch))
            for conn in conns:
                conn.close()
            events = []
            for u, tid, status, version, body, _ in outs:
                if status != 200:
                    raise AssertionError(f"{u}: answered {status} {body}")
                _check_result(body, 10, 1682)
                arm = "candidate" if version == winner else "stable"
                answers[arm] += 1
                if rng.random() < rates[arm]:
                    conversions[arm] += 1
                    events.append({"event": "reward", "entityType": "user", "entityId": u,
                                   "properties": {"traceId": tid}})
            for lo in range(0, len(events), 50):
                status, results, _ = _http(f"{es}/batch/events.json?accessKey={rest['access_key']}",
                                           events[lo:lo + 50])
                if status != 200 or any(r.get("status") != 201 for r in results):
                    raise AssertionError(f"reward batch: {status} {results[:2]}")
            n += len(outs)
        steps["canary_to_promote_s"] = time.perf_counter() - t2
        _wait(lambda: state().get("state") == "idle", 120, "the episode closing")
        steps["episode_wall_s"] = time.perf_counter() - t0
        final = read_json_file(state_path)
        if final["policy"]["lastOutcome"] != "promoted" or final["lastDecision"]["action"] != "warm":
            raise AssertionError(f"episode: {final}")
        warm = re.findall(r"cache warmed for (\S+): \{'ok': (\d+), 'error': (\d+)\}", session.err("lifecycle2"))
        if len(warm) != 1 or warm[0][0] != winner or int(warm[0][2]) or not 0 < int(warm[0][1]) <= 8:
            raise AssertionError(f"the warm: {warm}\n{session.err('lifecycle2')}")
        warmed = int(warm[0][1])
        levents = smoke_storage(home).get_l_events()
        app_id, _ = resolve_app(smoke_storage(home), "restapp", None)
        hits0 = _queries_total(base, "pio_cache_hits_total")
        for _, query in iter_event_users(levents, app_id, limit=8):
            if _http(base + "/queries.json", query)[0] != 200:
                raise AssertionError(f"warm query {query} not answered 200")
        hits = _queries_total(base, "pio_cache_hits_total") - hits0
        trains = [_lines(p) for p in logs]
        devices = sorted({ln.split()[1] for t in trains for ln in t})
        retrained = trains_at_kill - finished_at_kill
        if (len(trains[1]) != LIFECYCLE_CELLS - finished_at_kill + 1 or retrained > 1 or devices != ["cpu"]
                or hits != warmed):
            raise AssertionError(f"{finished_at_kill} cells at the kill, {trains_at_kill} trains before it, "
                                 f"{len(trains[1])} after; devices {devices}; {hits} cache hits of {warmed}")
        # the server's own loop ticks here, so the answers of the waves in
        # flight at its verdict (at most two) are no pulls, and rewards not
        # yet read then are never credited; bandit_inprocess holds both exactly
        bandit_json = store.load_bandit_state(engine_id)
        late = {arm: (answers[arm] - bandit_json[arm]["pulls"], conversions[arm] - bandit_json[arm]["rewards"])
                for arm in answers}
        if bandit_json.get("ended") != "promote" or bandit_json["candidate"]["version"] != winner or any(
                not (0 <= p and 0 <= r) for p, r in late.values()) or sum(p for p, _ in late.values()) > 2 * wave:
            raise AssertionError(f"bandit.json {bandit_json}; answers {answers}, conversions {conversions}")
        ring = [(r.get("kind"), r.get("event")) for r in TelemetryRing(ring_dir).records()]
        if [e for k, e in ring if k == "lifecycle"] != ["triggered", "tuning", "baking", "finished"]:
            raise AssertionError(f"ring: {ring}")
        c2.send_signal(signal.SIGINT)  # a clean exit writes its report
        c2.wait(timeout=30)

        def control_verbs():  # in order: each reads and rewrites the control file
            out = []
            for verb in ("trigger", "pause", "resume"):
                run(f"lifecycle_{verb}", "lifecycle", verb, "--obs-dir", obs)
                out.append(read_json_file(os.path.join(state_dir, "lifecycle-control.json")))
            return out

        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            control = pool.submit(control_verbs)
            status_text, status_json, top_json, top_lc = [pool.submit(run, *a) for a in (
                ("lifecycle_status", "lifecycle", "status", "--obs-dir", obs),
                ("lifecycle_status_json", "lifecycle", "status", "--obs-dir", obs, "--json"),
                ("top_json", "top", "--once", "--json", "--url", base),
                ("top_lifecycle", "top", "--lifecycle", state_path, "--once"))]
            admin, dash = pool.submit(session.start, "adminserver", "adminserver", "--registry-dir", registry), \
                pool.submit(session.start, "dashboard", "dashboard", "--metrics-url", base)
            control, admin, dash = control.result(), admin.result(), dash.result()
            status_text, status_json, top_json, top_lc = (f.result()[0] for f in (
                status_text, status_json, top_json, top_lc))
        if "state  idle" not in status_text or "last promoted" not in status_text \
                or json.loads(status_json)["policy"]["lastOutcome"] != "promoted":
            raise AssertionError(f"lifecycle status:\n{status_text}\n{status_json}")
        if control != [{"trigger": 1}, {"trigger": 1, "paused": True}, {"trigger": 1, "paused": False}]:
            raise AssertionError(f"control file: {control}")
        bandit_line = json.loads(top_json)["bandit"]
        if bandit_line["active"] or bandit_line["promotions_total"] != 1 or bandit_line["pulls"] != {
                arm: bandit_json[arm]["pulls"] for arm in answers}:
            raise AssertionError(f"pio top's bandit line: {bandit_line}")
        if f"lifecycle {engine_id}" not in top_lc or "last promoted" not in top_lc:
            raise AssertionError(f"pio top --lifecycle:\n{top_lc}")
        apps = _http(admin + "/cmd/app")[1]
        models = _http(admin + f"/cmd/models/{store.engine_key(engine_id)}")[1]
        if "restapp" not in [a["name"] for a in apps] or models["state"]["stable"] != winner \
                or winner not in [m["version"] for m in models["versions"]]:
            raise AssertionError(f"admin server: {apps} {models['state']}")
        page = _get(dash, "/")[2]
        if f"<h3>{base}</h3><table>" not in page or 'class="unreachable"' in page:
            raise AssertionError(f"dashboard page without the server's panel:\n{page[:2000]}")
    finally:
        session.stop_all()
    session.foreign(skip=killed)
    launches = {}
    for name, proc in (("deploy", session.started["deploy"]), ("lifecycle", c2)):
        with open(proc.report) as fh:
            launches[name] = json.load(fh)["launches"]["spd_cg"]
    if launches["lifecycle"]:
        raise AssertionError(f"the retune's cells launched B1 on the card: {launches}")
    result = {"host_numbers": True, **steps, "cells": LIFECYCLE_CELLS, "cells_at_kill": finished_at_kill,
              "trains_before_kill": trains_at_kill, "trains_after_restart": len(trains[1]),
              "cells_retrained": retrained, "cell_devices": devices, "winner": winner, "queries_to_promote": n,
              "answers": answers, "conversions": conversions, "bandit_json": bandit_json,
              "warm_queries": warmed, "warm_cache_hits": hits,
              "spd_cg_launches": launches, "drift_line": {k: drift[0][k] for k in ("guard", "measured", "threshold")}}
    emit(phase="lifecycle_cli", **result)
    return result


@phase
def stream_b1_rows(torch, home: str, n_events: int = 5_000) -> list[dict]:
    """B1 at a fold-in's rank-10 shape: the event server's rank-10 model
    folding 5,000 rate events (as registry_cli streams them) in-process;
    the first absorb's user and item systems held and timed."""
    import datetime as dt

    from predictionio_tpu_torch.stream import FoldInALSTrainer
    from predictionio_tpu_torch.workflow import model_io

    storage = smoke_storage(home)
    instance = storage.get_meta_data_engine_instances().get_latest_completed("smoke-rest", "1", "engine.json")
    (model,) = model_io.deserialize_models(storage.get_model_data_models().get(instance.id).models)
    rng = np.random.default_rng(41)
    active = rng.choice(len(model.user_vocab), 50, replace=False)
    events = _rating_events(model, rng, active[rng.integers(0, 50, 1_000)], [f"b1-new{j}" for j in range(400)],
                            rng.integers(0, len(model.user_vocab), 400), n_events - 1_000,
                            dt.datetime.now(tz=dt.timezone.utc))
    trainer = FoldInALSTrainer([model], device="cuda")
    systems = {}
    trainer.solve_hook = lambda side, order, A, b, x: systems.setdefault(side, (A.clone(), b.clone(), x.clone()))
    # the first absorb's systems: a fresh fold at the stream's batch limit
    trainer.absorb(events[:500])
    rows = []
    for side in ("user", "item"):
        A, b, x = systems[side]
        rows.append({"systems": f"stream fold-in, ML-100K {side}s of one absorb (rank 10)",
                     **b1_held(torch, A, b, 1e-4, f"a rank-10 fold-in's {side} side", x=x),
                     **b1_times(torch, A, b)})
        emit(phase="kernel_real", kernel="spd_cg", **rows[-1])
    return rows


# ---------------------------------------------------------------------------
# ANN retrieval (predictionio_tpu_torch/ann): answers held to float64
# ---------------------------------------------------------------------------

ANN_RTOL = 1e-5  # f32 scores of the search against float64 on the host
_VEC_NORMS: dict[int, tuple] = {}  # id(vector table) -> (the table, its largest row norm)


def _probe_sets(cs: np.ndarray, nprobe: int) -> list[np.ndarray]:
    """The probe sets a float32 stage 1 may choose given the float64
    centroid scores ``cs`` [C] of a query: the nprobe best, filled at the
    boundary in every way that scores within f32 rounding of it allow."""
    thr = np.partition(cs, len(cs) - nprobe)[len(cs) - nprobe]
    tol = 1e-5 * max(1.0, float(np.abs(cs).max()))
    must = np.flatnonzero(cs > thr + tol)
    maybe = np.flatnonzero(np.abs(cs - thr) <= tol)
    if len(maybe) > 8:
        raise AssertionError(f"{len(maybe)} centroids tie at the probe boundary")
    return [np.concatenate([must, np.asarray(c, np.int64)])
            for c in itertools.combinations(maybe, nprobe - len(must))]


def _topk_held(got_s, got_i, k: int, allowed: tuple, certain: tuple, tol) -> str | None:
    """None when (got_s, got_i) is a top-k of the candidates: each finite
    answer an allowed candidate at its float64 score, none twice, sorted,
    and every certain candidate above the k-th answer present (so ids may
    differ only inside a run of tied scores). ``allowed`` / ``certain``:
    (ids, float64 scores), certain ⊆ allowed (the int8 pool's sure members)."""
    fin = np.isfinite(got_s)
    gs, gi = got_s[fin].astype(np.float64), got_i[fin].astype(np.int64)
    ids, scores = allowed
    if not min(k, len(certain[0])) <= len(gs) <= min(k, len(ids)):
        return f"{len(gs)} answers for {len(certain[0])}..{len(ids)} candidates at k={k}"
    if len(np.unique(gi)) != len(gi):
        return f"an id twice: {gi.tolist()}"
    if len(gs) > 1 and np.any(np.diff(gs) > tol(gs[:-1])):
        return f"not sorted: {gs.tolist()}"
    order = np.argsort(ids, kind="stable")
    at = np.minimum(np.searchsorted(ids, gi, sorter=order), len(ids) - 1)
    found = ids[order[at]] == gi
    if not found.all():
        return f"ids {gi[~found].tolist()} are not allowed candidates"
    want = scores[order[at]]
    if np.any(np.abs(want - gs) > tol(want)):
        return f"scores {gs.tolist()} against float64 {want.tolist()}"
    floor = gs[-1] if len(gs) == k else -np.inf
    need = certain[0][certain[1] > floor + tol(floor)]
    missing = need[~np.isin(need, gi)]
    return f"missing {missing[:5].tolist()} above the k-th score {floor!r}" if len(missing) else None


def ann_answers_held(index, queries: np.ndarray, scores: np.ndarray, ids: np.ndarray, k: int, *,
                     nprobe: int | None = None, exclude: np.ndarray | None = None,
                     mask: np.ndarray | None = None, exact_table: np.ndarray | None = None,
                     what: str = "") -> int:
    """Holds every row of an ANN answer (``scores``/``ids`` [B, k] from
    ``AnnSearcher.fetch``) to the exact top-k over that query's probed
    candidates, computed in float64 from the index's host arrays: scores
    within rtol ``ANN_RTOL``, ids as sets inside a run of tied scores. With
    ``exclude`` ([B, E], -1 padded) or ``mask`` ([B, n] bool) those
    candidates are out. An int8 index is held to the exact rescore
    (``exact_table`` [n, f]) of its survivor pool, a pool member at the
    boundary of the int8 scores allowed in or out. Raises on the first rows
    that fail; returns the rows checked."""
    nprobe = nprobe or index.nprobe
    f = index.dim
    held_table, vec_norm = _VEC_NORMS.get(id(index.bucket_vecs), (None, 0.0))
    if held_table is not index.bucket_vecs:  # the largest vector of the index, once per index
        vec_norm = float(np.linalg.norm(index.bucket_vecs.reshape(-1, f).astype(np.float64), axis=1).max())
        if index.quantized:
            vec_norm = max(vec_norm * float(index.bucket_scale.max()),
                           float(np.linalg.norm(exact_table, axis=1).max()))
        _VEC_NORMS[id(index.bucket_vecs)] = (index.bucket_vecs, vec_norm)
    q_all = np.asarray(queries, np.float64).reshape(-1, f)[: len(scores)]
    cs_all = q_all @ index.centroids.astype(np.float64).T  # [B, C] stage 1 in float64
    bad = []
    for r in range(len(scores)):
        q64 = q_all[r]
        atol = 1e-6 * float(np.linalg.norm(q64)) * vec_norm

        def tol(s, atol=atol):
            return ANN_RTOL * np.abs(s) + atol

        err = None
        for probe in _probe_sets(cs_all[r], nprobe):
            cand = index.bucket_ids[probe].ravel().astype(np.int64)
            ok = cand >= 0
            if exclude is not None:
                ok &= ~np.isin(cand, exclude[r][exclude[r] >= 0])
            if mask is not None:
                ok &= mask[r][np.maximum(cand, 0)]
            vecs = index.bucket_vecs[probe].reshape(-1, f)[ok].astype(np.float64)
            cand = cand[ok]
            if index.quantized:
                s8 = (vecs @ q64) * index.bucket_scale[probe].ravel()[ok].astype(np.float64)
                exact = exact_table[cand].astype(np.float64) @ q64
                pool = min(max(k, index.config.rescore * k), nprobe * index.bucket_cap)
                if len(cand) > pool:
                    th = np.sort(s8)[::-1][pool - 1]
                    inside, sure = s8 >= th - tol(th), s8 > th + tol(th)
                else:
                    inside = sure = np.ones(len(cand), bool)
                allowed, certain = (cand[inside], exact[inside]), (cand[sure], exact[sure])
            else:
                allowed = certain = (cand, vecs @ q64)
            err = _topk_held(scores[r], ids[r], k, allowed, certain, tol)
            if err is None:
                break
        if err is not None:
            bad.append((r, err))
    if bad:
        raise AssertionError(f"ANN answers of {what} differ from the exact top-{k} over their "
                             f"probed candidates in {len(bad)} of {len(scores)} rows: {bad[:3]}")
    return len(scores)


def recall_at(ann_ids: np.ndarray, exact_ids: np.ndarray, k: int) -> float:
    """Mean overlap of the ANN top-k with the exact top-k."""
    hits = sum(len(set(np.asarray(a[:k]).tolist()) & set(np.asarray(e[:k]).tolist()))
               for a, e in zip(ann_ids, exact_ids))
    return hits / float(len(exact_ids) * k)


def ann_bench_corpus(n: int = 100_000, f: int = 32, batches: int = 40, batch: int = 64, seed: int = 7):
    """bench.py's ANN corpus and queries (phase_ann, bench.py:1607-1640):
    ``n`` clustered unit vectors at width f around max(32, n/512) modes,
    and ``batches`` batches of ``batch`` queries from the same modes, from
    the same generator in the same order."""
    modes_n = max(32, n // 512)
    rng = np.random.default_rng(seed)
    modes = rng.normal(size=(modes_n, f))
    modes /= np.linalg.norm(modes, axis=1, keepdims=True)
    vecs = (modes[rng.integers(0, modes_n, n)] + 0.15 * rng.normal(size=(n, f))).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    queries = (modes[rng.integers(0, modes_n, (batches, batch))]
               + 0.15 * rng.normal(size=(batches, batch, f))).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=2, keepdims=True)
    return vecs, queries


ANN_RECALL_GATE = 0.976  # the JAX package's 0.996 on this corpus (docs/ann.md) less 0.02


@phase
def ann_searcher_phase(torch) -> dict:
    """(a) The searcher at the JAX package's own ANN size: bench.py's
    100,000-vector corpus at f = 32, indexes built on the card at
    AnnConfig(min_items=0) and default sizing, f32 and int8. Each search
    (search, search_excl with each query's exact top-3 excluded,
    search_masked with a seeded half of the corpus masked, search_q8) over
    40 batches of 64 queries at k = 16, every answer held to the exact
    top-k over its probed candidates in float64 (ann_answers_held);
    recall@10 against the full exact top-k, the candidates scored, and the
    dispatch-to-fetch p50 beside the exact dot_top_k's on the same corpus."""
    from predictionio_tpu_torch.ann import AnnConfig, build_index
    from predictionio_tpu_torch.ann.search import AnnSearcher
    from predictionio_tpu_torch.ops import topk

    n, f, k, kk = 100_000, 32, 10, 16
    vecs, queries = ann_bench_corpus(n, f)
    table = torch.tensor(vecs, device="cuda")

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3

    topk.fetch_topk(topk.dot_top_k_async(table, queries[0].copy(), None, kk))
    exact = [timed(lambda q=q: topk.fetch_topk(topk.dot_top_k_async(table, q.copy(), None, kk)))
             for q in queries]
    exact_idx = np.concatenate([idx for (_, idx), _ in exact])
    exact_p50 = float(np.percentile([ms for _, ms in exact], 50))
    mask = np.random.default_rng(8).random((queries.shape[1], n)) < 0.5
    excl = [np.concatenate([idx[:, :3], np.full((len(idx), 1), -1, idx.dtype)], 1).astype(np.int32)
            for (_, idx), _ in exact]
    out = {"corpus": [n, f], "batches": list(queries.shape[:2]), "k": kk, "exact_p50_ms": exact_p50}
    for name, quantize in (("f32", False), ("int8", True)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        index = build_index(vecs, AnnConfig(min_items=0, quantize_int8=quantize), model_version="smoke",
                            device="cuda")
        build_s = time.perf_counter() - t0
        searcher = AnnSearcher(index, exact_table=table if quantize else None, device="cuda")
        kinds = {"search_q8": lambda b: {}} if quantize else {
            "search": lambda b: {}, "search_excl": lambda b: {"exclude": excl[b]},
            "search_masked": lambda b: {"mask": mask}}
        rec = {"clusters": index.clusters, "bucket_cap": index.bucket_cap, "nprobe": index.nprobe,
               "hbm_bytes": index.hbm_bytes(), "build_s": build_s}
        for kind, kw_of in kinds.items():
            AnnSearcher.fetch(searcher.search_async(queries[0].copy(), kk, **kw_of(0)))
            lat, ids, counts, held = [], [], [], 0
            for b, q in enumerate(queries):
                kw = kw_of(b)
                (s, i, c), ms = timed(lambda: AnnSearcher.fetch(searcher.search_async(q.copy(), kk, **kw)))
                lat.append(ms)
                held += ann_answers_held(index, q, s, i, kk, exclude=kw.get("exclude"), mask=kw.get("mask"),
                                         exact_table=vecs if quantize else None, what=f"{kind} batch {b}")
                ids.append(i)
                counts.append(c)
            frac = float(np.concatenate(counts).mean()) / n
            rec[kind] = {"p50_ms": float(np.percentile(lat, 50)), "p95_ms": float(np.percentile(lat, 95)),
                         "rows_held": held, "candidates_frac": frac,
                         "ann_over_exact_p50": float(np.percentile(lat, 50)) / exact_p50}
            if kind in ("search", "search_q8"):
                rec[kind]["recall_at_10"] = recall_at(np.concatenate(ids), exact_idx, k)
        out[name] = rec
    if not (out["f32"]["search"]["recall_at_10"] >= ANN_RECALL_GATE
            and out["f32"]["search"]["candidates_frac"] <= 0.10):
        raise AssertionError(f"ANN searcher: {out['f32']['search']} (recall gate {ANN_RECALL_GATE}, "
                             "candidates <= 0.10)")
    emit(phase="ann_searcher", **out)
    return out


def synthesize_views(n_users: int, n_items: int, n: int, seed: int = 0):
    """The users and items of synthesize_ratings (its first two draws from
    the same generator), without the ratings."""
    rng = np.random.default_rng(seed)
    users = rng.integers(0, n_users, n).astype(np.int32)
    items = (rng.zipf(1.3, n).astype(np.int64) % n_items).astype(np.int32)
    return users, items


SIMILAR_FACTORY = "predictionio_tpu_torch.models.similarproduct.engine.engine_factory"
SIMILAR_ANN_ENGINE = "smoke-similar-ann"


@phase
def similarproduct_ann_phase(torch, home: str, n_queries: int = 1_000, n_users: int = 138_000,
                             n_items: int = 100_000, n_views: int = 10_000_000) -> dict:
    """(b) Similar-product at a 100,000-item catalog, deployed from the
    registry: ML-20M's 138,000 users and 10 M events as views of 100,000
    items (synthesize_ratings' draws), 200 categories; ALSAlgorithm at
    rank 10, 10 iterations (20 B1 launches, the last systems of each side
    held by b1_rows_held at row-relative 1e-4 and timed); published through
    core_workflow._publish_to_registry, which pins an index at the default
    AnnConfig (its sha256 verified on load); a QueryServer deployed from
    that registry answers 1,000 queries of 1-5 items (half with 20 of the
    200 categories) from 16 clients, each answered 200 and held to the
    exact top-10 over its probed candidates, 0 fallbacks, the recall
    shadow's gauge read (PIO_ANN_RECALL_EVERY=4); the same queries are sent
    again in turns exact, ANN, exact (the index detached for the exact
    path), for the p50 of each path and the recall@10 of the ANN answers
    against the exact ones. Then an int8 index of the
    same version: filter-less batches through search_q8 (held to the exact
    rescore of their pool), filtered ones counted as fallbacks and equal to
    the exact path."""
    from predictionio_tpu_torch.ann import AnnConfig, build_index, lifecycle
    from predictionio_tpu_torch.ann.metrics import AnnInstruments
    from predictionio_tpu_torch.models.similarproduct import engine as sp
    from predictionio_tpu_torch.ops import als as als_ops
    from predictionio_tpu_torch.registry import ArtifactStore
    from predictionio_tpu_torch.workflow import model_io
    from predictionio_tpu_torch.workflow.context import WorkflowContext
    from predictionio_tpu_torch.workflow.core_workflow import _publish_to_registry
    from predictionio_tpu_torch.workflow.create_server import ServerConfig, create_query_server
    from predictionio_tpu_torch.workflow.engine_loader import EngineManifest

    users, items = synthesize_views(n_users, n_items, n_views)
    cats = _item_categories(n_items, 200)
    td = sp.TrainingData([f"u{i}" for i in range(n_users)], [f"i{i}" for i in range(n_items)], cats,
                         users, items, users[:0], items[:0])
    views_per_item = np.bincount(items, minlength=n_items)
    del users, items
    algo = sp.ALSAlgorithm(sp.ALSAlgorithmParams(**GALLERY_ALS))
    last = {}
    solve = als_ops.batched_spd_solve_auto

    def capture(A, b):  # the last systems of each side, for b1_rows_held
        x = solve(A, b)
        last[A.shape[0]] = (A.clone(), b.clone(), x.clone())
        return x

    als_ops.batched_spd_solve_auto = capture
    try:
        model, train_s, launches = _counted_train(torch, algo, WorkflowContext(device="cuda"), td)
    finally:
        als_ops.batched_spd_solve_auto = solve
    if launches != 2 * GALLERY_ALS["num_iterations"]:
        raise AssertionError(f"similar-product at 100,000 items: B1 launched {launches} times")
    rows = []
    for side, n_side in (("user", n_users + 1), ("item", n_items + 1)):
        A, b, x = last.pop(n_side)
        rows.append({"systems": f"similar-product at 100,000 items, {side} side, implicit rank 10",
                     **b1_held(torch, A, b, 1e-4, f"the 100,000-item similar-product {side} side", x=x),
                     **b1_times(torch, A, b)})
        emit(phase="kernel_real", kernel="spd_cg", **rows[-1])
        del A, b, x
    timings = {k: v for k, v in (algo.timings or {}).items() if k.endswith("_s")}

    work = os.path.join(home, "similar_ann")
    registry = os.path.join(work, "registry")
    engine_dir = os.path.join(work, "engine")
    os.makedirs(engine_dir)
    with open(os.path.join(engine_dir, "engine.json"), "w") as fh:
        json.dump({"id": SIMILAR_ANN_ENGINE, "engineFactory": SIMILAR_FACTORY,
                   "datasource": {"params": {"appName": "simapp"}},
                   "algorithms": [{"name": "als", "params": {
                       "rank": 10, "numIterations": 10, "lambda": 0.01, "alpha": 1.0, "seed": 3}}]}, fh)
    manifest = EngineManifest(engine_id=SIMILAR_ANN_ENGINE, version="1", variant="engine.json",
                              engine_factory=SIMILAR_FACTORY)
    if os.environ.get("PIO_ANN_MIN_ITEMS") or os.environ.get("PIO_ANN_CLUSTERS") or os.environ.get("PIO_ANN_NPROBE"):
        raise AssertionError("the default AnnConfig is asked for: PIO_ANN_* must be unset")
    t0 = time.perf_counter()
    _publish_to_registry(manifest, "", model_io.serialize_models([model]), {}, train_s, "", registry, 5,
                         models=[model], device="cuda")
    publish_s = time.perf_counter() - t0
    store = ArtifactStore(registry)
    version = store.get_state(SIMILAR_ANN_ENGINE).stable
    pinned = store.get_manifest(SIMILAR_ANN_ENGINE, version)
    meta = pinned.ann_index if pinned is not None else None
    default = AnnConfig().resolved(n_items)
    if not meta or store.load_ann_blob(SIMILAR_ANN_ENGINE, version) is None \
            or (meta["clusters"], meta["nprobe"], meta["builtFrom"], meta["items"]) != \
            (default.clusters, default.nprobe, "train", n_items):
        raise AssertionError(f"the train-time publish pinned no default index: {meta}")

    recall_every = os.environ.get("PIO_ANN_RECALL_EVERY")
    os.environ["PIO_ANN_RECALL_EVERY"] = "4"
    try:
        ctx = WorkflowContext(mode="serving", device="cuda", _storage=smoke_storage(work))
        t0 = time.perf_counter()
        # the cache off: the phase counts index searches and compares the
        # exact path with the index's on the same payloads
        server = create_query_server(engine_dir, ctx, ServerConfig(ip="127.0.0.1", port=0, registry_dir=registry,
                                                                   result_cache_size=0))
        deploy_s = time.perf_counter() - t0
    finally:
        if recall_every is None:
            os.environ.pop("PIO_ANN_RECALL_EVERY")
        else:
            os.environ["PIO_ANN_RECALL_EVERY"] = recall_every
    served = server.models[0]
    ann = getattr(served, lifecycle.ATTR, None)
    if ann is None or ann.index.model_version != version:
        server.shutdown()
        raise AssertionError("the server deployed from the registry attached no index")
    rng = np.random.default_rng(43)
    seen = np.flatnonzero(views_per_item >= 5)
    all_cats = sorted({c for s in cats for c in s})
    payloads = []
    for r in range(n_queries):
        payload = {"items": [f"i{i}" for i in rng.choice(seen, int(rng.integers(1, 6)), replace=False)], "num": 10}
        if r % 2:
            payload["categories"] = rng.choice(all_cats, 20, replace=False).tolist()
        payloads.append(payload)
    base = f"http://127.0.0.1:{server.start()}"

    def run_all():
        with concurrent.futures.ThreadPoolExecutor(16) as pool:
            got = list(pool.map(lambda p: _query(base, p), payloads))
        if any(status != 200 for status, _, _, _ in got):
            raise AssertionError("similar-product at 100,000 items: a query was not answered 200")
        return got

    ins = server.ann_instruments
    try:
        outs = run_all()
        counts = {"ann_queries": ins.queries.value(), "fallbacks": ins.fallbacks.value(),
                  "candidates_frac": ins.candidates_frac.value(), "recall_sampled": ins.recall_sampled.value(),
                  "recall_samples": ins.recall_samples.value()}
        # the same queries with the index detached (the exact path), in turns
        p50s = {"ann": [_p50_ms([s for _, _, _, s in outs])], "exact": []}
        exact_outs = None
        for path in ("exact", "ann", "exact"):
            if path == "exact":
                delattr(served, lifecycle.ATTR)
            else:
                setattr(served, lifecycle.ATTR, ann)
            got = run_all()
            p50s[path].append(_p50_ms([s for _, _, _, s in got]))
            exact_outs = exact_outs or (got if path == "exact" else None)
    finally:
        server.shutdown()
    served_recall = float(np.mean([
        len({x["item"] for x in a["itemScores"]} & {x["item"] for x in e["itemScores"]})
        / max(1, len(e["itemScores"])) for (_, a, _, _), (_, e, _, _) in zip(outs, exact_outs)]))
    held = 0
    for payload, (_, body, _, _) in zip(payloads, outs):
        q = sp.Query.from_json_dict(payload)
        qidx = [served.item_index(i) for i in q.items]
        got = body["itemScores"]
        held += ann_answers_held(
            ann.index, served.item_factors[qidx].sum(0, dtype=np.float64)[None],
            np.asarray([[x["score"] for x in got]], np.float32),
            np.asarray([[served.item_index(x["item"]) for x in got]], np.int64), 10,
            mask=sp.candidate_mask(served, q, qidx)[None], what=f"the server's answer to {payload}")
    serve = {"queries": n_queries, "clients": 16, "rows_held": held,
             "query_p50_ms": p50s["ann"][0], "deploy_s": deploy_s, **counts,
             "query_p50_ms_turns": p50s, "recall_at_10_against_exact_answers": served_recall}
    if serve["ann_queries"] != n_queries or serve["fallbacks"] != 0 or serve["recall_samples"] == 0:
        raise AssertionError(f"similar-product ANN instruments: {serve}")

    # int8: filter-less batches through search_q8, filtered ones exact (counted)
    t0 = time.perf_counter()
    index8 = build_index(served.item_factors, AnnConfig(quantize_int8=True), model_version=version, device="cuda")
    build8_s = time.perf_counter() - t0
    ins8 = AnnInstruments()
    setattr(served, lifecycle.ATTR, lifecycle.AnnServing(index8, served, instruments=ins8, recall_sample_every=0,
                                                         device="cuda"))
    plain = sp.ALSAlgorithm(sp.ALSAlgorithmParams(**GALLERY_ALS))
    n_plain = n_filtered = held8 = 0
    for lo in range(0, min(1024, len(payloads)), 128):
        for filtered in (False, True):
            qs = [sp.Query.from_json_dict(p) for p in payloads[lo:lo + 128] if ("categories" in p) == filtered]
            got = plain.predict_batch(served, qs)
            if filtered:
                n_filtered += len(qs)
                ann8 = getattr(served, lifecycle.ATTR)
                delattr(served, lifecycle.ATTR)
                want = plain.predict_batch(served, qs)
                setattr(served, lifecycle.ATTR, ann8)
                if [[(x.item, x.score) for x in r.item_scores] for r in got] != \
                        [[(x.item, x.score) for x in r.item_scores] for r in want]:
                    raise AssertionError("int8: a filtered batch differs from the exact path")
                continue
            n_plain += len(qs)
            qidx = [[served.item_index(i) for i in q.items] for q in qs]
            excl = np.full((len(qs), 5), -1, np.int64)
            for r, row in enumerate(qidx):
                excl[r, :len(row)] = row
            held8 += ann_answers_held(
                index8, np.stack([served.item_factors[row].sum(0, dtype=np.float64) for row in qidx]),
                np.asarray([[x.score for x in r.item_scores] for r in got], np.float32),
                np.asarray([[served.item_index(x.item) for x in r.item_scores] for r in got], np.int64), 10,
                exclude=excl, exact_table=served.item_factors, what="the int8 similar-product dispatch")
    if ins8.queries.value() != n_plain or ins8.fallbacks.value() != n_filtered:
        raise AssertionError(f"int8 routing: {ins8.queries.value()} ANN queries of {n_plain}, "
                             f"{ins8.fallbacks.value()} fallbacks of {n_filtered}")
    delattr(served, lifecycle.ATTR)
    out = {"shape": [n_users, n_items, n_views], "train_wall_s": train_s, **timings, "spd_cg_launches": launches,
           "publish_with_index_s": publish_s, "index": meta, "serve": serve,
           "int8": {"build_s": build8_s, "hbm_bytes": index8.hbm_bytes(), "q8_rows_held": held8,
                    "q8_queries": ins8.queries.value(), "filtered_fallbacks": ins8.fallbacks.value()}}
    emit(phase="similarproduct_ann", **out)
    remove_work(work)
    return {"launches": {"similarproduct_ann_train": launches}, "rows": rows}


def _attach_index(model, table, what: str):
    """An index at AnnConfig(min_items=0) over ``table``, built on the card
    and attached to ``model`` under ann.lifecycle.ATTR (as bench.py builds
    one); returns its AnnServing and the build's seconds."""
    from predictionio_tpu_torch.ann import AnnConfig, build_index, lifecycle
    from predictionio_tpu_torch.ann.metrics import AnnInstruments

    t0 = time.perf_counter()
    index = build_index(table, AnnConfig(min_items=0), model_version=what, device="cuda")
    build_s = time.perf_counter() - t0
    serving = lifecycle.AnnServing(index, model, instruments=AnnInstruments(), recall_sample_every=0,
                                   device="cuda")
    setattr(model, lifecycle.ATTR, serving)
    return serving, build_s


def _answers_of(model, results, k: int):
    """(scores [B, k], item indices [B, k]) of engine answers, -inf/-1 padded."""
    index = {it: i for i, it in enumerate(model.item_vocab)}
    scores = np.full((len(results), k), -np.inf, np.float32)
    ids = np.full((len(results), k), -1, np.int64)
    for r, res in enumerate(results):
        for c, s in enumerate(res.item_scores[:k]):
            scores[r, c], ids[r, c] = s.score, index[s.item]
    return scores, ids


@phase
def twotower_ann_phase(torch, model, algo, n_dispatch: int = 12, batch: int = 64) -> dict:
    """(c) The two-tower model of the train phase (27,000 items) through an
    index at AnnConfig(min_items=0): predict_batch_dispatch in batches of 64
    users, one B2 launch each (the history encoder of the user tower), every
    answer held to the exact top-10 over its probed candidates for its user
    vector (recomputed outside the count), recall@10 against the exact path."""
    from predictionio_tpu_torch.ann import lifecycle
    from predictionio_tpu_torch.models.twotower import engine as tt
    from predictionio_tpu_torch.ops import attention as A

    serving, build_s = _attach_index(model, model.item_embeddings, "twotower")
    rng = np.random.default_rng(24)
    picks = [rng.integers(0, len(model.user_vocab), batch) for _ in range(n_dispatch)]
    batches = [[tt.Query(user=model.user_vocab[u], num=10) for u in rows] for rows in picks]
    algo.predict_batch_dispatch(model, batches[0])()  # first use outside the count
    A.fused_attention_block.launches = 0
    lat, served = [], []
    for queries in batches:
        t0 = time.perf_counter()
        served.append(algo.predict_batch_dispatch(model, queries)())
        lat.append((time.perf_counter() - t0) * 1e3)
    launches = A.fused_attention_block.launches
    if launches != n_dispatch:
        raise AssertionError(f"two-tower ANN: B2 launched {launches} times for {n_dispatch} dispatches")
    held, got_ids = 0, []
    for rows, results in zip(picks, served):
        with torch.no_grad():
            qv = model.embed_users_async(rows.astype(np.int32), model.history[rows]).cpu().numpy()
        scores, ids = _answers_of(model, results, 10)
        held += ann_answers_held(serving.index, qv, scores, ids, 10, what="the two-tower ANN dispatch")
        got_ids.append(ids)
    delattr(model, lifecycle.ATTR)
    exact_ids = [_answers_of(model, algo.predict_batch(model, q), 10)[1] for q in batches]
    out = {"items": len(model.item_vocab), "clusters": serving.index.clusters, "nprobe": serving.index.nprobe,
           "bucket_cap": serving.index.bucket_cap, "build_s": build_s, "dispatches": n_dispatch,
           "attention_block_launches": launches, "rows_held": held,
           "dispatch_p50_ms": float(np.percentile(lat, 50)),
           "recall_at_10": recall_at(np.concatenate(got_ids), np.concatenate(exact_ids), 10),
           "candidates_frac": serving.instruments.candidates_frac.value()}
    emit(phase="twotower_ann", **out)
    return out


@phase
def sequential_ann_phase(torch, model, sessions, n_dispatch: int = 12, batch: int = 64) -> dict:
    """(c) The sequential model (3,706 items) through an index at
    AnnConfig(min_items=0): predict_batch_dispatch in batches of 64 at
    context 200 (one B2 launch a dispatch) and 1024 (one B3 launch), the
    session items excluded by id in the search, every answer held to the
    exact top-10 over its probed candidates for its session vector
    (recomputed outside the count), recall@10 against the exact path."""
    from predictionio_tpu_torch.ann import lifecycle
    from predictionio_tpu_torch.models.sequential import engine as seq
    from predictionio_tpu_torch.ops import attention as A

    serving, build_s = _attach_index(model, model.item_out, "sequential")
    vocab = model.item_vocab
    by_length = np.argsort([-len(s) for s in sessions], kind="stable")
    rng = np.random.default_rng(25)
    out, launches = {}, {"attention_block": {}, "flash_attention": {}}
    for context in (200, 1024):
        algo = seq.AttentionAlgorithm(seq.AttentionAlgorithmParams(rank=32, context=context))
        pool = by_length[:batch] if context == 1024 else rng.permutation(len(sessions))
        batches = [[seq.Query(recent_items=tuple(vocab[i] for i in sessions[pool[(d * batch + r) % len(pool)]][-context:]),
                              num=10) for r in range(batch)] for d in range(n_dispatch)]
        A.fused_attention_block.launches = 0
        A.flash_attention.launches = 0
        lat, served = [], []
        for queries in batches:
            t0 = time.perf_counter()
            served.append(algo.predict_batch_dispatch(model, queries)())
            lat.append((time.perf_counter() - t0) * 1e3)
        counts = {"attention_block": A.fused_attention_block.launches, "flash_attention": A.flash_attention.launches}
        want = "attention_block" if A.route(context, context) == "block" else "flash_attention"
        if counts[want] != n_dispatch or sum(counts.values()) != n_dispatch:
            raise AssertionError(f"sequential ANN at context {context}: launches {counts}")
        launches[want][f"ann_context_{context}"] = counts[want]
        held, got_ids = 0, []
        for queries, results in zip(batches, served):
            hist, _, sess, bb = algo._stage_batch(model, queries)
            excl = algo._exclude_rows(sess, bb)
            with torch.no_grad():
                ctx = algo._encode(model.device_in(), torch.from_numpy(hist.copy()).cuda()).float().cpu().numpy()
            scores, ids = _answers_of(model, results, 10)
            held += ann_answers_held(serving.index, ctx[:batch], scores, ids, 10, exclude=excl[:batch],
                                     what=f"the sequential ANN dispatch at context {context}")
            got_ids.append(ids)
        ann = getattr(model, lifecycle.ATTR)
        delattr(model, lifecycle.ATTR)
        exact_ids = [_answers_of(model, algo.predict_batch(model, q), 10)[1] for q in batches]
        setattr(model, lifecycle.ATTR, ann)
        out[f"context_{context}"] = {
            "launches": counts, "rows_held": held, "dispatch_p50_ms": float(np.percentile(lat, 50)),
            "recall_at_10": recall_at(np.concatenate(got_ids), np.concatenate(exact_ids), 10)}
    delattr(model, lifecycle.ATTR)
    out.update(items=len(vocab), clusters=serving.index.clusters, nprobe=serving.index.nprobe,
               bucket_cap=serving.index.bucket_cap, build_s=build_s)
    emit(phase="sequential_ann", **out)
    return {"launches": launches, **out}


# ---------------------------------------------------------------------------
# More than one rank (parallel/, ops/als_sharded.py, two-tower's mesh):
# each job is this script run as ``--rank-phase NAME WORK`` once per rank
# through the port's launcher; every rank writes WORK/NAME.w<world>.rank<r>.json
# ---------------------------------------------------------------------------

TT_PARALLEL_MESHES = [("data=2,model=1", False, "ring"), ("data=1,model=2", True, "ring"),
                      ("data=1,model=2", True, "ulysses")]
# half the ML-20M id tables' f32 parameter, gradient and two Adam moments
TT_HALF_TABLES_BYTES = (138_000 + 27_000) * 64 * 4 * 4 // 2


def _rank_job(name: str, n: int, work: str, timeout: float = 600.0) -> tuple[list[dict], float]:
    """``chip_smoke.py --rank-phase name work`` as an ``n``-rank job through
    the port's MultiHostLauncher (each rank's output on stderr, prefixed);
    every rank's result and the job's wall seconds. A rank that fails
    fails the job; past ``timeout`` seconds the launcher reaps them all."""
    from predictionio_tpu_torch.parallel.launcher import MultiHostLauncher

    here = os.path.dirname(os.path.abspath(__file__))
    launcher = MultiHostLauncher(command=[sys.executable, os.path.join(here, "chip_smoke.py"), "--rank-phase",
                                          name, work],
                                 num_hosts=n, env_extra={"PYTHONPATH": here})
    timer = threading.Timer(timeout, launcher.terminate)
    timer.start()
    t0 = time.perf_counter()
    try:
        result = launcher.run()
    finally:
        timer.cancel()
    wall = time.perf_counter() - t0
    if not result.ok:
        raise AssertionError(f"{name} on {n} ranks: exit codes {result.returncodes} after {wall:.1f} s")
    outs = []
    for r in range(n):
        with open(os.path.join(work, f"{name}.w{n}.rank{r}.json")) as fh:
            outs.append(json.load(fh))
    return outs, wall


def sharded_als_rank(torch, work: str, n_users: int = 138_000, n_items: int = 27_000,
                     n_ratings: int = 20_000_000) -> dict:
    """One rank of the sharded ALS train at the ML-20M shape (train_phase's
    ratings and held-out split, read from WORK/ratings.npz, and its
    config): B1's two launches of the first
    iteration held to the plain version on this rank's own systems, the
    launches counted, each iteration's all-gather seconds, held-out RMSE."""
    from predictionio_tpu_torch.ops import als as als_mod
    from predictionio_tpu_torch.ops.als import ALSConfig
    from predictionio_tpu_torch.ops.als_sharded import als_train_sharded
    from predictionio_tpu_torch.ops.spd_solve import batched_spd_solve_fused
    from predictionio_tpu_torch.parallel import distributed

    rt = distributed.runtime()
    t0 = time.perf_counter()
    with np.load(os.path.join(work, "ratings.npz")) as z:  # synthesize_ratings', as train_phase drew them
        users, items, vals, test = z["users"], z["items"], z["vals"], z["test"]
    if users.shape[0] != n_ratings or int(users.max()) >= n_users or int(items.max()) >= n_items:
        raise AssertionError(f"ratings.npz holds {users.shape[0]} ratings, not {n_ratings}")
    data_s = time.perf_counter() - t0
    solve, held = als_mod.batched_spd_solve_auto, []

    def holding(A, b):
        x = solve(A, b)
        if len(held) < 2:  # the first iteration's user and item solves
            side = ("user", "item")[len(held)]
            if side == "user" and rt.rank == 0 and rt.world_size == 2:  # timed by the main process
                np.save(os.path.join(work, "b1_A.npy"), A.cpu().numpy())
                np.save(os.path.join(work, "b1_b.npy"), b.cpu().numpy())
            held.append({"side": side, "n": int(b.shape[0]), "f": int(b.shape[1]),
                         **b1_held(torch, A, b, 1e-3, f"rank {rt.rank}'s first {side} solve", x=x)})
        return x

    als_mod.batched_spd_solve_auto = holding
    batched_spd_solve_fused.launches = 0
    timings: dict = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    uf, vf = als_train_sharded(users[~test], items[~test], vals[~test], n_users, n_items,
                               ALSConfig(rank=32, iterations=10, reg=0.05, chunk=65536), timings=timings)
    train_wall_s = time.perf_counter() - t0
    launches = batched_spd_solve_fused.launches
    pred = np.sum(uf[users[test]] * vf[items[test]], 1)
    if rt.rank == 0:
        np.save(os.path.join(work, f"sharded_als.w{rt.world_size}.uf.npy"), uf)
        np.save(os.path.join(work, f"sharded_als.w{rt.world_size}.vf.npy"), vf)
    return {"rank": rt.rank, "world": rt.world_size, "backend": rt.backend, "device": str(rt.device),
            "spd_cg_launches": launches, "held": held, "data_s": data_s, "train_wall_s": train_wall_s,
            "timings": timings, "heldout_rmse": float(np.sqrt(np.mean((pred - vals[test]) ** 2))),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "max_memory_allocated": torch.cuda.max_memory_allocated()}


@phase
def sharded_als_phase(torch, home: str) -> dict:
    """ALS at the ML-20M shape across ranks: 2 ranks sharing the card over
    gloo (tensors on the card, collectives staged through the host), then
    1 rank over NCCL (its init and all-gathers on the card). Each rank
    launches B1 twice an iteration (its users', then its items' systems),
    the first two held to the plain version; held-out RMSE <= 0.45; the
    2-rank factors against train_phase's one-rank als_train from the same
    initial factors (explicit ALS: the sharded init is _als_init's draw):
    the held-out RMSE within 1e-3 and the median row-relative factor
    difference within 1e-2 (f32 sums in another order through 10
    iterations of CG stopped at f + 4 steps; 4e-4 to 6e-4 in a CPU
    rehearsal at 3,000 x 2,000)."""
    one_rank = ONE_RANK_ALS
    work = work_dir(prefix="pio_smoke_sharded_", dir=home)
    t0 = time.perf_counter()
    users, items, vals, test = one_rank["ratings"]
    np.savez(os.path.join(work, "ratings.npz"), users=users, items=items, vals=vals, test=test)
    gloo, gloo_wall = _rank_job("sharded_als", 2, work)
    nccl, nccl_wall = _rank_job("sharded_als", 1, work)
    uf = np.load(os.path.join(work, "sharded_als.w2.uf.npy"))
    vf = np.load(os.path.join(work, "sharded_als.w2.vf.npy"))

    def row_rel(a, b):
        return np.linalg.norm(a - b, axis=1) / np.maximum(np.linalg.norm(b, axis=1), 1e-30)

    rel_u, rel_i = row_rel(uf, one_rank["user_factors"]), row_rel(vf, one_rank["item_factors"])
    steps = {
        "phase_s": time.perf_counter() - t0, "gloo_job_wall_s": gloo_wall, "nccl_job_wall_s": nccl_wall,
        "ranks": [{k: r[k] for k in ("rank", "world", "backend", "device", "spd_cg_launches", "data_s",
                                     "train_wall_s", "heldout_rmse", "peak_mem_gb", "max_memory_allocated")}
                  | {"gather_s": r["timings"]["gather_s"], "pack_s": r["timings"]["pack_s"],
                     "upload_s": r["timings"]["upload_s"], "device_s": r["timings"]["device_s"],
                     "held": r["held"]} for r in gloo + nccl],
        "one_rank_rmse": one_rank["rmse"],
        "median_row_rel_user": float(np.median(rel_u)), "median_row_rel_item": float(np.median(rel_i)),
        "max_row_rel_user": float(rel_u.max()), "max_row_rel_item": float(rel_i.max()),
    }
    emit(phase="sharded_als", gpu=GPU, **steps)
    for r in gloo + nccl:
        want_backend = "gloo" if r["world"] == 2 else "nccl"
        if r["backend"] != want_backend or r["spd_cg_launches"] != 20 or len(r["held"]) != 2:
            raise AssertionError(f"sharded_als rank {r['rank']} of {r['world']}: backend {r['backend']}, "
                                 f"B1 launched {r['spd_cg_launches']} times (20 expected), held {r['held']}")
        if not r["heldout_rmse"] <= 0.45:
            raise AssertionError(f"sharded_als on {r['world']} ranks: held-out RMSE {r['heldout_rmse']}")
    if abs(gloo[0]["heldout_rmse"] - one_rank["rmse"]) > 1e-3 or max(np.median(rel_u), np.median(rel_i)) > 1e-2:
        raise AssertionError(f"2-rank factors against the one-rank train: {steps}")
    return {"work": work, "peaks_w2": [r["max_memory_allocated"] for r in gloo],
            "launches": {f"sharded_als_w{r['world']}_rank{r['rank']}": r["spd_cg_launches"] for r in gloo + nccl},
            "rows": [{"systems": f"sharded ALS, rank {r['rank']} of {r['world']}, first {h['side']} solve",
                      "n": h["n"], "f": h["f"], "max_abs_err": h["max_abs_err"],
                      "max_row_rel_err": h["max_row_rel_err"], "limit": h["limit"]}
                     for r in gloo + nccl for h in r["held"]]}


def twotower_parallel_rank(torch, work: str, n_users: int = 138_000, n_items: int = 27_000,
                           n_slice: int = 1_000_000, batch: int = 4096, steps: int = 4) -> dict:
    """One rank of two-tower training across 2 ranks at the template's
    widths (historyLen 256, batch 4096; twotower_train_phase's data): on
    each mesh of TT_PARALLEL_MESHES, ``steps`` steps from one init, the loss
    of the first batch before and after them (finite and falling), B2's
    launches and its first launch held to the plain version; rank 0 also
    takes the one-rank step on the first global batch (f32 reference
    attention for ring, whose blocks are f32) and holds the mesh's step-1
    loss (rtol 1e-4), its summed gradients (each within 1e-2 of its
    tensor's largest entry plus 1e-6: the bf16 towers round a batch
    slice's partial sums where one rank rounds the whole batch's) and its
    updated parameters to it (Adam's first step moves each by about lr,
    whatever the gradient's size: equal within 1e-6 or, where a near-zero
    gradient's sign flipped, within 2 lr, at most 1 % of them). On the
    model=2 meshes the user and item tables are sharded: a shard is held
    to its rows of the one-rank tensors. Each mesh's parameter, Adam and
    gradient bytes on this rank (exact nbytes sums; the first two equal to
    describe_shardings' per-device sum) and its max_memory_allocated; on
    ulysses one more step through inspect_train_step (its collectives and
    flags, the model and Adam put back)."""
    from predictionio_tpu_torch.models.twotower import model as M
    from predictionio_tpu_torch.obs import xray
    from predictionio_tpu_torch.ops import attention as A
    from predictionio_tpu_torch.parallel import distributed
    from predictionio_tpu_torch.parallel.mesh import make_mesh

    rt = distributed.runtime()
    users, items, _ = synthesize_ratings(n_users, n_items, 10 * n_slice)
    users, items = users[:n_slice], items[:n_slice]
    times = np.random.default_rng(21).random(n_slice) * 1e8
    hist = torch.from_numpy(M.build_history_matrix(users, items, times, n_users, 256).astype(np.int64)).cuda()
    users_d = torch.from_numpy(users.astype(np.int64)).cuda()
    items_d = torch.from_numpy(items.astype(np.int64)).cuda()
    log_q = torch.from_numpy(M.item_log_q(items, n_items)).cuda()
    perm = torch.from_numpy(np.random.default_rng(0).permutation(n_slice)).cuda()
    batches = [perm[s * batch:(s + 1) * batch] for s in range(steps)]
    block, forward, held = A.fused_attention_block, A._fused_attention_forward, []

    def holding(q, k, v, causal):
        out = forward(q, k, v, causal)
        if not held:
            plain = A._fused_attention_plain(q, k, v, causal)
            err = float((out - plain).abs().max())
            scale = max(1.0, float(plain.abs().max()))
            held.append({"shape": list(q.shape), "max_abs_err": err, "limit": ATTENTION_ATOL * scale})
            if not err <= ATTENTION_ATOL * scale:
                raise AssertionError(f"B2 on rank {rt.rank} at {tuple(q.shape)}: {err} from the plain version")
            if rt.rank == 0:  # ulysses' block (1 head) and data=2's (2 heads), timed by the main process
                for name, t in zip("qkv", (q, k, v)):
                    np.save(os.path.join(work, f"b2_h{q.shape[1]}_{name}.npy"), t.detach().cpu().numpy())
        return out

    out = {"rank": rt.rank, "world": rt.world_size, "backend": rt.backend, "meshes": []}
    for spec, cp, impl in TT_PARALLEL_MESHES:
        torch.cuda.reset_peak_memory_stats()
        mesh = make_mesh(spec, "cuda")
        config = M.TwoTowerConfig(n_users=n_users, n_items=n_items, embed_dim=64, hidden=(128,), out_dim=32,
                                  n_heads=2, history_len=256, batch_size=batch, context_parallel=cp, sp_impl=impl)
        model = M.build_model(config, "cuda", mesh)
        opt = M.make_optimizer(model, config.learning_rate)
        step = M.make_train_step(model, opt, config.temperature, True, log_q, mesh)
        ub, ib = users_d[batches[0]], items_d[batches[0]]
        with torch.no_grad():
            loss_before = float(M.global_batch_loss(model, ub, ib, config.temperature, hist, log_q, mesh))
        held.clear()
        A._fused_attention_forward = holding
        block.launches = 0
        step_s, losses = [], []
        try:
            for s, sel in enumerate(batches):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                losses.append(float(step(users_d[sel], items_d[sel], hist)))
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t0)
                if s == 0 and rt.rank == 0:  # the summed gradients stay in .grad until the next step
                    after_one = {n: p.detach().clone() for n, p in model.named_parameters()}
                    grads_one = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
        finally:
            A._fused_attention_forward = forward
        launches = block.launches
        with torch.no_grad():
            loss_after = float(M.global_batch_loss(model, ub, ib, config.temperature, hist, log_q, mesh))
        tables = M.sharded_tables(model)
        rows = {n: slice(m.start, m.start + m.weight.shape[0]) for n, m in tables.items()}
        param_bytes = sum(p.nbytes for p in model.parameters())
        adam_bytes = sum(v.nbytes for st in opt.state.values() for v in st.values() if torch.is_tensor(v))
        grad_bytes = sum(p.grad.nbytes for p in model.parameters())
        described = sum(e["per_device_bytes"] for e in xray.describe_shardings({"params": model, "opt": opt}, mesh))
        if described != param_bytes + adam_bytes:
            raise AssertionError(f"describe_shardings on {spec}: {described} B a rank, the tensors hold "
                                 f"{param_bytes + adam_bytes}")
        row = {"mesh": spec, "sp_impl": impl if cp else None, "losses": losses, "step_s": step_s,
               "loss_before": loss_before, "loss_after": loss_after, "attention_block_launches": launches,
               "held": list(held), "sharded": sorted(tables),
               "table_rows": {n: [r.start, r.stop] for n, r in rows.items()},
               "param_bytes": param_bytes, "adam_bytes": adam_bytes, "grad_bytes": grad_bytes,
               "max_memory_allocated": torch.cuda.max_memory_allocated()}
        if cp and impl == "ulysses":  # one more step, counted and put back
            t0 = time.perf_counter()
            report = xray.inspect_train_step(step, ub, ib, hist, arg_names=("user_ids", "item_ids", "hist"))
            flagged = sorted(e["name"] for e in xray.find_replicated(report["arrays"]))
            row["inspect"] = {"collectives": report["collectives"], "flags": report["flags"],
                              "flagged": flagged, "seconds": time.perf_counter() - t0}
            tables_flagged = {"params.user_tower.embed.weight", "params.item_tower.embed.weight"} & set(flagged)
            if "params.hist_encoder.hist_embed.weight" not in flagged or tables_flagged:
                raise AssertionError(f"inspect_train_step on {spec}: flags {report['flags']}")
        if not (np.all(np.isfinite(losses)) and loss_after < loss_before):
            raise AssertionError(f"two-tower on {spec} ({row['sp_impl']}): losses {losses}, first batch "
                                 f"{loss_before} -> {loss_after}: not finite and falling")
        del model, opt, step
        if rt.rank == 0:  # the one-rank step on the same global batch, same init
            real = M.fused_attention
            if cp and impl == "ring":
                M.fused_attention = A.attention_reference
            try:
                single = M.build_model(config, "cuda")
                sopt = M.make_optimizer(single, config.learning_rate)
                sloss = float(M.make_train_step(single, sopt, config.temperature, True, log_q)(ub, ib, hist))
            finally:
                M.fused_attention = real
            moved = total = 0
            worst = grad_excess = 0.0
            for n, p in single.named_parameters():
                mine = rows.get(n, slice(None))  # a shard against its rows of the whole table
                diff = (after_one[n] - p.detach()[mine]).abs()
                worst = max(worst, float(diff.max()))
                moved += int((diff > 1e-6).sum())
                total += diff.numel()
                g1 = (p.grad.detach() if p.grad is not None else torch.zeros_like(p))[mine]
                gerr = float((grads_one[n] - g1).abs().max())
                grad_excess = max(grad_excess, gerr / (1e-2 * float(g1.abs().max()) + 1e-6))
            row.update(one_rank_loss=sloss, params_moved_otherwise=moved, params=total, max_param_diff=worst,
                       grad_err_over_limit=grad_excess)
            if abs(losses[0] - sloss) > 1e-4 * abs(sloss) or worst > 2 * config.learning_rate + 1e-6 \
                    or moved > 0.01 * total or not grad_excess <= 1.0:
                raise AssertionError(f"two-tower on {spec} ({row['sp_impl']}) against one rank: {row}")
            del single, sopt, after_one, grads_one
        out["meshes"].append(row)
        torch.cuda.empty_cache()
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


@phase
def twotower_parallel_phase(torch, home: str) -> dict:
    """Two-tower training on 2 ranks sharing the card (gloo): data=2
    (batch halves, one global in-batch softmax), and model=2 with
    context_parallel under ring (no B2: f32 online softmax blocks) and
    under ulysses (one B2 launch a step on each rank, over the whole
    history of one head). Each rank's checks are twotower_parallel_rank's;
    here each rank's B2 launches: one a step where its encoder attends
    locally, none under ring."""
    work = work_dir(prefix="pio_smoke_ttpar_", dir=home)
    t0 = time.perf_counter()
    ranks, wall = _rank_job("twotower_parallel", 2, work)
    launches = {}
    for r in ranks:
        for m in r["meshes"]:
            want = 0 if m["sp_impl"] == "ring" else len(m["losses"])
            if m["attention_block_launches"] != want or (want and not m["held"]):
                raise AssertionError(f"two-tower on {m['mesh']} ({m['sp_impl']}), rank {r['rank']}: B2 launched "
                                     f"{m['attention_block_launches']} times, {want} expected")
            launches[f"twotower_parallel_{m['mesh']}_{m['sp_impl'] or 'dp'}_rank{r['rank']}"] = \
                m["attention_block_launches"]
        if r["backend"] != "gloo":
            raise AssertionError(f"two ranks on one card ran {r['backend']}, not gloo")
        # the model=2 meshes hold half of each id table a rank: its parameter,
        # both Adam moments and its gradient, (138,000 + 27,000) x 64 x 4 B x 4 / 2
        whole = next(m for m in r["meshes"] if not m["sharded"])
        for m in r["meshes"]:
            if m["sharded"]:
                less = sum(whole[k] - m[k] for k in ("param_bytes", "adam_bytes", "grad_bytes"))
                m["bytes_less_than_whole_tables"] = less
                if less != TT_HALF_TABLES_BYTES or sorted(m["sharded"]) != ["item_tower.embed.weight",
                                                                            "user_tower.embed.weight"]:
                    raise AssertionError(f"two-tower on {m['mesh']} ({m['sp_impl']}), rank {r['rank']}: "
                                         f"{less} B less than whole tables, {TT_HALF_TABLES_BYTES} expected; "
                                         f"sharded {m['sharded']}")
    emit(phase="twotower_parallel", gpu=GPU, job_wall_s=wall, phase_s=time.perf_counter() - t0, ranks=ranks)
    return {"work": work, "launches": launches,
            "rows": [{"systems": f"two-tower {m['mesh']} {m['sp_impl']}, rank {r['rank']}", **h}
                     for r in ranks for m in r["meshes"] for h in m["held"]]}


@phase
def sharded_cli_phase(torch, home: str, device: str = "cuda", n_queries: int = 200) -> dict:
    """pio train --num-hosts 2 of the recommendation template with
    distributed: true (ML-100K shape: 943 x 1,682 x 100,000 ratings, rank
    10) on the CLI's sqlite event store: two ranks sharing the card over
    gloo; the coordinator alone records the engine instance (with each
    rank's kernel launches: B1 twice an iteration on both) and the model.
    Then a single-process pio deploy and 200 POST /queries.json from 8
    clients, each answered 200 and equal to serve_batch of the persisted
    model (scores at rtol 1e-5, ids compared as sets within a run of tied
    scores, as the other CLI phases hold theirs), an unknown user's empty."""
    from predictionio_tpu_torch.ops.als import ServingIndex
    from predictionio_tpu_torch.workflow import model_io

    t_phase = time.perf_counter()
    n_users, n_items, n_ratings = 943, 1682, 100_000
    users, items, vals = synthesize_ratings(n_users, n_items, n_ratings, seed=5)
    work = work_dir(prefix="pio_smoke_sharded_cli_", dir=home)
    events = os.path.join(work, "events.jsonl")
    with open(events, "w") as fh:
        for k, (u, i, r) in enumerate(zip(users.tolist(), items.tolist(), vals.tolist())):
            fh.write(json.dumps({
                "event": "rate", "entityType": "user", "entityId": f"u{u}",
                "targetEntityType": "item", "targetEntityId": f"i{i}", "properties": {"rating": r},
                "eventTime": f"2024-01-01T{k // 360000 % 24:02d}:{k // 6000 % 60:02d}:{k // 100 % 60:02d}."
                             f"{k % 100:03d}Z",
            }) + "\n")
    engine_dir = os.path.join(work, "engine")
    os.makedirs(engine_dir)
    with open(os.path.join(engine_dir, "engine.json"), "w") as fh:
        json.dump({"id": "smoke-sharded", "engineFactory":
                   "predictionio_tpu_torch.models.recommendation.engine.engine_factory",
                   "datasource": {"params": {"appName": "shardedapp"}},
                   "algorithms": [{"name": "als", "params": {"rank": 10, "numIterations": 10, "lambda": 0.05,
                                                             "seed": 3, "distributed": True}}]}, fh)
    home_cli = os.path.join(work, "home")
    cli, env, run = _cli(home_cli)
    steps = {"app_new_s": run("app", "new", "shardedapp"),
             "import_s": run("import", "--appname", "shardedapp", "--input", events),
             "train_s": run("train", "--engine-dir", engine_dir, "--device", device, "--num-hosts", "2")}
    storage = smoke_storage(home_cli)
    instances = storage.get_meta_data_engine_instances().get_all()
    if len(instances) != 1 or instances[0].status != "COMPLETED":
        raise AssertionError(f"pio train --num-hosts 2 recorded {[(i.id, i.status) for i in instances]}")
    launches = json.loads(instances[0].spark_conf["kernel_launches"])
    if [r["spd_cg"] for r in launches] != [20, 20]:
        raise AssertionError(f"B1 launches by rank {launches}: 20 on each of 2 ranks expected")
    (model,) = model_io.deserialize_models(storage.get_model_data_models().get(instances[0].id).models)
    index = ServingIndex(model.user_factors, model.item_factors, device)
    server, base, steps["deploy_ready_s"] = _start_deploy(cli, env, engine_dir, work, device)
    try:
        asked = [f"u{u}" for u in np.random.default_rng(6).integers(0, n_users, n_queries)]
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            outs = list(pool.map(lambda u: _http(base + "/queries.json", {"user": u, "num": 10}), asked))
        known = []
        for u, (status, body, _) in zip(asked, outs):
            if status != 200:
                raise AssertionError(f"query for {u} answered {status}")
            if model.user_index(u) is not None:
                known.append((u, body["itemScores"]))
            elif body["itemScores"]:
                raise AssertionError(f"unknown user {u} answered {body['itemScores']}")
        # the server's micro-batches are not serve_batch's shape, so scores
        # agree to rounding and near-tied items may trade places (_same_topk)
        ref_scores, ref_ids = index.serve_batch(np.asarray([model.user_index(u) for u, _ in known]), 20)
        _same_topk(np.asarray([[model.item_index(g["item"]) for g in got] for _, got in known]),
                   np.asarray([[g["score"] for g in got] for _, got in known]), ref_ids, ref_scores, 1e-5,
                   "sharded_cli: an answer is not serve_batch's")
        lat_ms = np.asarray([dt for _, _, dt in outs]) * 1e3
    finally:
        _stop(server)
    steps.update(queries=len(asked), all_200=True, p50_ms=float(np.percentile(lat_ms, 50)),
                 launches_by_rank=launches, train_wall_clock_s=float(instances[0].spark_conf["train_wall_clock_sec"]),
                 phase_s=time.perf_counter() - t_phase)
    emit(phase="sharded_cli", gpu=GPU, shape=[n_users, n_items, n_ratings], **steps)
    remove_work(work)
    return {"launches": {f"sharded_cli_rank{r}": c["spd_cg"] for r, c in enumerate(launches)}}


# the two-tower CLI on ranks: one bf16 ulp of a unit vector's entries, at
# which the served and the in-process scores may part (the user tower's
# bf16 products are cuBLAS calls of the micro-batch's shape)
TT_CLI_SCORE_ATOL = 2.0 ** -7


def _tt_answers_held(got: list, ref: list, what: str) -> int:
    """Each served answer (item, score) against the in-process answer of
    the persisted model at a deeper k: the scores within
    TT_CLI_SCORE_ATOL of the reference's top scores, and every served item
    one the reference scores at least its k-th score less that tolerance
    (ties and near-ties may trade places). Returns the answers held."""
    for g, r in zip(got, ref):
        k = len(g)
        if k != min(10, len(r)):
            raise AssertionError(f"{what}: {k} items served, the reference has {len(r)}")
        gs, rs = np.asarray([x["score"] for x in g]), np.asarray([x["score"] for x in r])
        if not np.allclose(gs, rs[:k], rtol=0, atol=TT_CLI_SCORE_ATOL):
            raise AssertionError(f"{what}: scores {gs} against {rs[:k]}")
        floor = rs[k - 1] - TT_CLI_SCORE_ATOL
        allowed = {x["item"]: x["score"] for x in r if x["score"] >= floor}
        for x in g:
            if x["item"] not in allowed or abs(allowed[x["item"]] - x["score"]) > TT_CLI_SCORE_ATOL:
                raise AssertionError(f"{what}: served {x} outside the reference's {sorted(allowed)}")
    return len(got)


@phase
def twotower_sharded_cli_phase(torch, home: str, device: str = "cuda", n_queries: int = 200,
                               epochs: int = 2) -> dict:
    """pio train --num-hosts 2 of the two-tower template with mesh
    data=1,model=2 (its id tables sharded over the two ranks, contextParallel
    off: each rank attends the whole batch through B2), historyLen 256,
    batch 4096, on an ML-100K-shape view file: 944 users (the JAX
    placement refuses 943 over model=2) x 1,682 items x 100,000 views,
    every user and item seen. The coordinator alone records the instance
    (each rank's B2 launches: one a step) and the model, whose tables are
    whole. Then a single-process pio deploy (its B2 launches counted at
    exit) and 200 POST /queries.json from 8 clients, each answered 200 and
    held to the in-process answer of the persisted model
    (:func:`_tt_answers_held`); an unknown user's empty."""
    from predictionio_tpu_torch.models.twotower import engine as tt
    from predictionio_tpu_torch.ops import attention as A
    from predictionio_tpu_torch.workflow import model_io

    t_phase = time.perf_counter()
    n_users, n_items, n_views, batch = 944, 1682, 100_000, 4096
    users, items, _ = synthesize_ratings(n_users, n_items, n_views, seed=8)
    users[:n_items], items[:n_items] = np.arange(n_items) % n_users, np.arange(n_items)
    work = work_dir(prefix="pio_smoke_tt_sharded_", dir=home)
    events = os.path.join(work, "events.jsonl")
    with open(events, "w") as fh:
        for k, (u, i) in enumerate(zip(users.tolist(), items.tolist())):
            fh.write(json.dumps({
                "event": "view", "entityType": "user", "entityId": f"u{u}",
                "targetEntityType": "item", "targetEntityId": f"i{i}",
                "eventTime": f"2024-01-01T{k // 360000 % 24:02d}:{k // 6000 % 60:02d}:{k // 100 % 60:02d}."
                             f"{k % 100:03d}Z",
            }) + "\n")
    engine_dir = os.path.join(work, "engine")
    os.makedirs(engine_dir)
    params = {"embedDim": 64, "hidden": [128], "outDim": 32, "epochs": epochs, "batchSize": batch,
              "historyLen": 256, "nHeads": 2, "mesh": "data=1,model=2", "contextParallel": False, "seed": 3}
    with open(os.path.join(engine_dir, "engine.json"), "w") as fh:
        json.dump({"id": "smoke-twotower-sharded",
                   "engineFactory": "predictionio_tpu_torch.models.twotower.engine.engine_factory",
                   "datasource": {"params": {"appName": "ttshardapp"}},
                   "algorithms": [{"name": "twotower", "params": params}]}, fh)
    home_cli = os.path.join(work, "home")
    cli, env, run = _cli(home_cli)
    steps = {"app_new_s": run("app", "new", "ttshardapp"),
             "import_s": run("import", "--appname", "ttshardapp", "--input", events),
             "train_s": run("train", "--engine-dir", engine_dir, "--device", device, "--num-hosts", "2")}
    storage = smoke_storage(home_cli)
    instances = storage.get_meta_data_engine_instances().get_all()
    if len(instances) != 1 or instances[0].status != "COMPLETED":
        raise AssertionError(f"pio train --num-hosts 2 recorded {[(i.id, i.status) for i in instances]}")
    launches = json.loads(instances[0].spark_conf["kernel_launches"])
    want = epochs * (n_views // batch)
    if device == "cuda" and [r["attention_block"] for r in launches] != [want, want]:
        raise AssertionError(f"B2 launches by rank {launches}: {want} on each of 2 ranks expected")
    (model,) = model_io.deserialize_models(storage.get_model_data_models().get(instances[0].id).models)
    shapes = {k: list(np.shape(model.params[k])) for k in ("user_tower.embed.weight", "item_tower.embed.weight")}
    if shapes != {"user_tower.embed.weight": [n_users, 64], "item_tower.embed.weight": [n_items, 64]}:
        raise AssertionError(f"the persisted tables are not whole: {shapes}")
    report = os.path.join(work, "deploy_report.json")
    port = _free_port()
    with open(os.path.join(work, "deploy.err"), "w") as err:
        server = subprocess.Popen([sys.executable, "-c", _CLI_LAUNCHER, report, "--home", home_cli, "deploy",
                                   "--engine-dir", engine_dir, "--device", device, "--ip", "127.0.0.1",
                                   "--port", str(port)], env=env, stdout=subprocess.DEVNULL, stderr=err)
    base = f"http://127.0.0.1:{port}"
    t0 = time.perf_counter()
    try:
        while True:
            if server.poll() is not None:
                with open(os.path.join(work, "deploy.err")) as fh:
                    raise AssertionError(f"deploy exited {server.returncode}: {fh.read()[-3000:]}")
            try:
                if _http(base + "/", timeout=2)[0] == 200:
                    break
            except (urllib.error.URLError, ConnectionError, TimeoutError):
                pass
            if time.perf_counter() - t0 > 180:
                raise AssertionError("deploy did not answer GET / within 180 s")
            time.sleep(0.2)
        steps["deploy_ready_s"] = time.perf_counter() - t0
        asked = [f"u{u}" for u in np.random.default_rng(6).integers(0, n_users, n_queries)]
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            outs = list(pool.map(lambda u: _http(base + "/queries.json", {"user": u, "num": 10}), asked))
        status, body, _ = _http(base + "/queries.json", {"user": "no-such-user", "num": 5})
        if status != 200 or body != {"itemScores": []}:
            raise AssertionError(f"unknown user answered {status} {body}")
        _, st, _ = _http(base + "/")
    finally:
        _stop(server)
    with open(report) as fh:
        server_launches = json.load(fh)["launches"]
    for u, (status, body, _) in zip(asked, outs):
        if status != 200:
            raise AssertionError(f"query for {u} answered {status}")
    # the persisted model in this process, on the card, at a deeper k
    model.device = device
    algo = tt.TwoTowerAlgorithm(tt.TwoTowerAlgorithmParams())
    A.fused_attention_block.launches = 0
    ref = algo.predict_batch(model, [tt.Query(u, 20) for u in asked])
    inprocess_launches = A.fused_attention_block.launches
    held = _tt_answers_held([b["itemScores"] for _, b, _ in outs],
                            [[{"item": x.item, "score": x.score} for x in r.item_scores] for r in ref],
                            "twotower_sharded_cli: an answer is not the persisted model's")
    if device == "cuda" and not (server_launches["attention_block"] >= st["batches"] > 0
                                 and inprocess_launches >= 1):
        raise AssertionError(f"B2 on the server: {server_launches} for {st['batches']} batches; "
                             f"in-process {inprocess_launches}")
    lat_ms = np.asarray([dt for _, _, dt in outs]) * 1e3
    steps.update(queries=len(asked), all_200=True, answers_held=held, p50_ms=float(np.percentile(lat_ms, 50)),
                 launches_by_rank=launches, server_launches=server_launches, server_batches=st["batches"],
                 train_wall_clock_s=float(instances[0].spark_conf["train_wall_clock_sec"]),
                 phase_s=time.perf_counter() - t_phase)
    emit(phase="twotower_sharded_cli", gpu=GPU, shape=[n_users, n_items, n_views], **steps)
    remove_work(work)
    return {"launches": {**{f"twotower_sharded_cli_rank{r}": c["attention_block"] for r, c in enumerate(launches)},
                         "twotower_sharded_cli_serve": server_launches["attention_block"]}}


# one line a statement: code.interact (without IPython) prompts again on a continuation
SHELL_SCRIPT = """import sys
names = dir()
print("BOUND", sorted(n for n in names if n in ("storage", "p_event_store", "l_event_store", "Event", "DataMap", "CleanupFunctions", "torch", "device")))
print("JAX", any(m.split(".")[0] in ("jax", "predictionio_tpu") for m in sys.modules))
x = torch.ones(3, device=device)
print("CUDA", torch.cuda.is_initialized(), str(x.device))
CleanupFunctions.add(lambda: print("HOOK ran"))
"""


def _gone(pid: int) -> bool:
    """A process that has exited (gone, or a zombie its new parent has not
    reaped yet)."""
    try:
        with open(f"/proc/{pid}/stat") as fh:
            return fh.read().rsplit(")", 1)[1].split()[0] == "Z"
    except FileNotFoundError:
        return True


@phase
def tools_cli_phase(home: str) -> dict:
    """The small verbs through the CLI: build and unregister of an engine
    directory (the JAX package's texts), start-all (the event server, the
    admin server and the dashboard answer GET /) then stop-all (no process
    of theirs left), and pio shell fed a script on the card and with
    --device cpu (the card hidden: CUDA not initialised)."""
    t_phase = time.perf_counter()
    work = work_dir(prefix="pio_smoke_tools_", dir=home)
    cli, env, _ = _cli(os.path.join(work, "home"))
    engine_dir = os.path.join(work, "engine")
    os.makedirs(engine_dir)
    with open(os.path.join(engine_dir, "engine.json"), "w") as fh:
        json.dump({"id": "smoke-tools", "engineFactory": "predictionio_tpu.models.recommendation.engine_factory",
                   "datasource": {"params": {"appName": "toolsapp"}},
                   "algorithms": [{"name": "als", "params": {"rank": 4}}]}, fh)

    def verb(*args, stdin=None, timeout=120):
        proc = subprocess.run([*cli, *args], env=env, input=stdin, capture_output=True, text=True,
                              timeout=timeout)
        if proc.returncode != 0:
            raise AssertionError(f"pio {args[0]} exited {proc.returncode}: {proc.stderr[-2000:]}")
        return proc.stdout

    texts = {"build": verb("build", "--engine-dir", engine_dir), "unregister": verb("unregister", "--engine-dir",
                                                                                       engine_dir)}
    want = {"build": "Engine smoke-tools is ready (factory predictionio_tpu.models.recommendation.engine_factory).\n",
            "unregister": "Nothing to unregister: engines are not registered. An engine is just its directory "
                          f"({engine_dir}); remove the directory (or its trained instances via the metadata "
                          "store) instead.\n"}
    if texts != want:
        raise AssertionError(f"build / unregister printed {texts}")
    ports = [_free_port() for _ in range(3)]
    out = verb("start-all", "--eventserver-port", str(ports[0]), "--adminserver-port", str(ports[1]),
               "--dashboard-port", str(ports[2]))
    pids = [int(line.split("pid ")[1].rstrip(")")) for line in out.splitlines() if line.startswith("started")]
    ready = {}
    try:
        t0 = time.perf_counter()
        for name, port in zip(("eventserver", "adminserver", "dashboard"), ports):
            while True:
                try:  # the dashboard answers HTML
                    with urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=2) as resp:
                        if resp.status == 200:
                            ready[name] = time.perf_counter() - t0
                            break
                except (urllib.error.URLError, ConnectionError, TimeoutError):
                    pass
                if time.perf_counter() - t0 > 120:
                    raise AssertionError(f"start-all: {name} did not answer GET / within 120 s")
                time.sleep(0.2)
    finally:
        verb("stop-all")
    t0 = time.perf_counter()
    while not all(_gone(pid) for pid in pids):
        if time.perf_counter() - t0 > 30:
            raise AssertionError(f"stop-all left {[pid for pid in pids if not _gone(pid)]}")
        time.sleep(0.2)
    stopped_s = time.perf_counter() - t0
    shells = {}
    for dev in ("cuda", "cpu"):
        # a line's REPL prompts ("In [2]: ", ">>> ") stand before what the script printed
        shells[dev] = [ln[min(i for i in (ln.find(k + " ") for k in ("BOUND", "JAX", "CUDA", "HOOK")) if i >= 0):]
                       for ln in verb("shell", "--device", dev, stdin=SHELL_SCRIPT).splitlines()
                       if any(k + " " in ln for k in ("BOUND", "JAX", "CUDA", "HOOK"))]
    bound = ("BOUND ['CleanupFunctions', 'DataMap', 'Event', 'device', 'l_event_store', 'p_event_store', "
             "'storage', 'torch']")
    for dev, cuda in (("cuda", "CUDA True cuda:0"), ("cpu", "CUDA False cpu")):
        if shells[dev] != [bound, "JAX False", cuda, "HOOK ran"]:
            raise AssertionError(f"pio shell --device {dev} printed {shells[dev]}")
    steps = {"services_ready_s": ready, "services_stopped_s": stopped_s, "pids": pids,
             "shell": shells, "phase_s": time.perf_counter() - t_phase}
    emit(phase="tools_cli", gpu=GPU, **steps)
    remove_work(work)
    return steps


# the rule registry of `pio lint`, the JAX analyzer's ids
LINT_RULES = 23
# a function appended to a copy of a serving module: its .cpu() must fire
LINT_SEED = "\n\ndef _seeded_fetch(scores):\n    return scores.cpu()\n"
# modules a `python -m predictionio_tpu_torch.analysis.cli` run must not load
LINT_FOREIGN = ("torch", "numpy", "jax", "predictionio_tpu")


def _py_files(top: str) -> int:
    """The .py files under ``top`` that `pio lint` walks (no __pycache__,
    no hidden, build or dist directories)."""
    n = 0
    for dirpath, dirnames, names in os.walk(top):
        dirnames[:] = [d for d in dirnames if not d.startswith(".")
                       and d not in ("__pycache__", "node_modules", "build", "dist")]
        n += sum(name.endswith(".py") for name in names)
    return n


@phase
def lint_cli_phase(home: str) -> dict:
    """`pio lint` of the port from the checkout, five processes started
    together (no git: the checkout may have none): ``pio lint --format
    json`` exits 0 with no finding over every .py file of the package and
    examples/; ``python -m predictionio_tpu_torch.analysis.cli --format
    json`` gives the same report and loads no torch, numpy, jax or JAX
    package module (its ``-X importtime`` record); ``--format sarif`` is
    SARIF 2.1.0 with the 23 rules; ``--report-suppressions`` lists no stale
    site; and on a copy of ``controller/serving.py`` with a ``.cpu()``
    appended, ``hostsync-serving-path`` fires at that line."""
    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    work = work_dir(prefix="pio_smoke_lint_", dir=home)
    seeded = os.path.join(work, "pkg", "controller", "serving.py")
    os.makedirs(os.path.dirname(seeded))
    with open(os.path.join(root, "predictionio_tpu_torch", "controller", "serving.py")) as fh:
        source = fh.read().rstrip("\n") + "\n"
    with open(seeded, "w") as fh:
        fh.write(source + LINT_SEED)
    seed_line = source.count("\n") + LINT_SEED.count("\n")
    env = {**os.environ, "PYTHONPATH": root}
    pio = [sys.executable, "-m", "predictionio_tpu_torch.tools.cli", "lint"]
    runs = {
        "pio_json": pio + ["--format", "json"],
        "module_json": [sys.executable, "-X", "importtime", "-m", "predictionio_tpu_torch.analysis.cli",
                        "--format", "json"],
        "sarif": pio + ["--format", "sarif"],
        "suppressions": pio + ["--report-suppressions"],
        "seeded": pio + ["--format", "json", os.path.join(work, "pkg")],
    }
    procs = {name: subprocess.Popen(cmd, cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                    text=True) for name, cmd in runs.items()}
    out, done_s = {}, {}
    for name, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=300)
        done_s[name] = time.perf_counter() - t_phase
        out[name] = (proc.returncode, stdout, stderr)
    for name in ("pio_json", "module_json", "sarif", "suppressions"):
        if out[name][0] != 0:
            raise AssertionError(f"lint {name} exited {out[name][0]}: {out[name][1][-2000:]}{out[name][2][-2000:]}")
    report = json.loads(out["pio_json"][1])
    n_files = _py_files(os.path.join(root, "predictionio_tpu_torch")) + _py_files(os.path.join(root, "examples"))
    if report["findings"] or report["files_scanned"] != n_files:
        raise AssertionError(f"pio lint: {len(report['findings'])} findings {report['findings'][:3]}, "
                             f"{report['files_scanned']} files of {n_files}")
    module = json.loads(out["module_json"][1])
    if {k: v for k, v in module.items() if k != "duration_s"} != {k: v for k, v in report.items()
                                                                   if k != "duration_s"}:
        raise AssertionError("python -m predictionio_tpu_torch.analysis.cli reported otherwise than pio lint")
    imported = {ln.split("|")[-1].strip() for ln in out["module_json"][2].splitlines()
                if ln.startswith("import time:") and "|" in ln}
    foreign = sorted(m for m in imported if m.split(".")[0] in LINT_FOREIGN)
    if "predictionio_tpu_torch.analysis.core" not in imported or foreign:
        raise AssertionError(f"the analyzer's process imported {foreign[:8]}")
    sarif = json.loads(out["sarif"][1])
    driver = sarif["runs"][0]["tool"]["driver"]
    if sarif["version"] != "2.1.0" or len(driver["rules"]) != LINT_RULES or sarif["runs"][0]["results"]:
        raise AssertionError(f"sarif: version {sarif['version']}, {len(driver['rules'])} rules, "
                             f"{len(sarif['runs'][0]['results'])} results")
    inventory = out["suppressions"][1].splitlines()
    sites, stale = (int(w) for w in re.match(r"(\d+) suppression site\(s\), (\d+) stale", inventory[-1]).groups())
    if stale or any(" STALE " in ln for ln in inventory):
        raise AssertionError(f"stale suppressions: {[ln for ln in inventory if ' STALE ' in ln]}")
    hits = [f for f in json.loads(out["seeded"][1])["findings"] if f["rule"] == "hostsync-serving-path"]
    if out["seeded"][0] != 1 or [f["line"] for f in hits] != [seed_line]:
        raise AssertionError(f"the seeded .cpu() at line {seed_line}: exit {out['seeded'][0]}, {hits}")
    steps = {"files_scanned": n_files, "suppression_sites": sites, "lint_s": report["duration_s"],
             "done_s": done_s, "seeded_line": seed_line, "phase_s": time.perf_counter() - t_phase}
    emit(phase="lint_cli", **steps)
    remove_work(work)
    return steps


RANK_PHASES = {"sharded_als": sharded_als_rank, "twotower_parallel": twotower_parallel_rank}


@phase
def rest_cli_phases(torch, home: str, rest: dict) -> tuple[dict, dict]:
    """The offline verbs, then the registry verbs, on the event server's
    store (one after the other: the registry's stream adds events to it)."""
    return offline_cli_phase(torch, home, rest), registry_cli_phase(torch, home, rest)


@phase
def rank_phases(torch, home: str) -> dict:
    """The four phases of more than one rank, the small verbs and `pio
    lint`, one after another (run beside the main thread's phases: their
    ranks, verbs and lint runs are processes of their own)."""
    return {"sharded_cli": sharded_cli_phase(torch, home), "sharded_als": sharded_als_phase(torch, home),
            "twotower_parallel": twotower_parallel_phase(torch, home),
            "twotower_sharded_cli": twotower_sharded_cli_phase(torch, home),
            "tools_cli": tools_cli_phase(home), "lint_cli": lint_cli_phase(home)}


@phase
def rank_kernel_times(torch, ranks: dict) -> None:
    """B1 on rank 0's first user-side systems of the 2-rank sharded train
    and B2 on rank 0's ulysses and data=2 blocks, timed here while no other phase
    runs (beside their bounds, plain versions and library calls), as
    rows of the kernels line."""
    als_work, tt_work = ranks["sharded_als"].pop("work"), ranks["twotower_parallel"].pop("work")
    A, b = (torch.from_numpy(np.load(os.path.join(als_work, f"b1_{n}.npy"))).cuda() for n in ("A", "b"))
    row = {"systems": "sharded ALS, rank 0 of 2, first user solve", **b1_times(torch, A, b)}
    emit(phase="kernel_real", kernel="spd_cg", **row)
    ranks["sharded_als"]["rows"].append(row)
    del A, b
    for heads, label in ((1, "two-tower ulysses block, rank 0 of 2"), (2, "two-tower data=2 block, rank 0 of 2")):
        q, k, v = (torch.from_numpy(np.load(os.path.join(tt_work, f"b2_h{heads}_{n}.npy"))).cuda() for n in "qkv")
        ranks["twotower_parallel"]["rows"].append(b2_times(torch, q, k, v, label))
        del q, k, v
    remove_work(als_work)
    remove_work(tt_work)


def rank_phase_main(argv: list[str]) -> int:
    """``--rank-phase NAME WORK``: one rank of a job the launcher started
    (the PIO_COORDINATOR contract in the environment)."""
    import torch

    from predictionio_tpu_torch.parallel import distributed

    name, work = argv
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    distributed.maybe_initialize_distributed("cuda")
    rt = distributed.runtime()
    if rt is None:
        raise SystemExit("--rank-phase needs the launcher's PIO_COORDINATOR contract")
    result = RANK_PHASES[name](torch, work)
    with open(os.path.join(work, f"{name}.w{rt.world_size}.rank{rt.rank}.json"), "w") as fh:
        json.dump(result, fh)
    distributed.shutdown()
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from predictionio_tpu_torch.ops import _build

    global GPU
    smi = GPU = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    # the host library (g++) builds beside the kernels (nvcc)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        host_build = pool.submit(_build.build_host, "pio_scan")
        build_s = _build.build(KERNELS)
        host_build_s = host_build.result()
    emit(phase="env", gpu=smi, torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], kernel_build_s=build_s, host_library_build_s=host_build_s,
         host_compiler=_build.host_compiler(),
         ptxas={name: [ln.strip() for ln in _build.build_logs.get(name, "").splitlines()
                       if "registers" in ln or "spill" in ln] for name in KERNELS})
    home = work_dir(prefix="pio_smoke_home_")
    try:
        profiler_warm_up(torch, home)
        kernel_phase(torch)
        grid_row = kernel_grid_phase(torch)
        td, model, params, launches = train_phase(torch, home)
        _, kernel = real_system_check(torch, td, model, params, launches)
        doctor = doctor_start(os.path.join(home, "doctor"))
        cli_serve_phase(os.path.join(home, "cli"))
        doctor = doctor_phase(torch, doctor)
        # the phases of more than one rank start their own processes: they
        # run beside the phases up to the bandit's (whose latency veto must
        # not read another process's load on the card, and the fleet counts
        # the card's processes)
        ranks_pool = concurrent.futures.ThreadPoolExecutor(1)
        ranks_future = ranks_pool.submit(rank_phases, torch, home)
        rest = eventserver_phase(torch, os.path.join(home, "rest"))
        sql_es = sql_es_cli_phase(torch, os.path.join(home, "sql_es"))
        inprocess_serve_phase(torch, model)
        batchpredict_als_phase(torch, model)
        ann_searcher_phase(torch)
        foldin = stream_foldin_phase(torch, home, model)
        del td, model
        rollout_lanes_phase(torch, home, foldin)
        contract = serving_contract_inprocess_phase(torch, foldin)
        obs_inprocess_phase(torch, foldin, contract)
        ranks = ranks_future.result()
        ranks_pool.shutdown()
        rank_kernel_times(torch, ranks)
        doctor_mesh_check(doctor, ranks)
        bandit_inprocess_phase(torch, foldin)
        fleet_cli_phase(torch, foldin)
        foldin_rows, foldin_launches = foldin["rows"], foldin["launches"]
        del foldin
        # before registry_cli adds events to the event server's store
        eval_rows = eval_b1_rows(torch, os.path.join(home, "rest"))
        # the CLI-only phases side by side on three threads (each verb a
        # process of its own; none times a kernel or reads a latency
        # against a limit), beside in-process phases that do neither
        with concurrent.futures.ThreadPoolExecutor(3) as cli_pool:
            rest_cli = cli_pool.submit(rest_cli_phases, torch, os.path.join(home, "rest"), rest)
            seq_gallery = cli_pool.submit(lambda: (sequential_cli_phase(os.path.join(home, "seq_cli")),
                                                   gallery_cli_phase(os.path.join(home, "gallery_cli"))))
            tt_jsonl = cli_pool.submit(lambda: (twotower_cli_phase(os.path.join(home, "tt_cli")),
                                                jsonl_cli_phase(torch, os.path.join(home, "jsonl_cli"))))
            variants = rec_variants_phase(torch, home)
            twotower_quality_phase(torch)
            recuser = recommendeduser_phase(torch)
            offline, registry = rest_cli.result()
            seq_gallery.result()
            _, jsonl = tt_jsonl.result()
        lifecycle_cli_phase(torch, os.path.join(home, "rest"), rest, registry)
        fleet_lifecycle_cli_phase(torch, os.path.join(home, "rest"), rest, registry)
        foldin_rows += stream_b1_rows(torch, os.path.join(home, "rest"))
        rank160, rank160_launches = als_rank160_phase(torch, home)
        attention_kernel_phase(torch)
        wide_rows = wide_head_times(torch)
        seq_model, sessions, seq_launches = sequential_train_phase(torch, home)
        attention = sequential_serve_phase(torch, seq_model, sessions)
        seq_bp = batchpredict_sequential_phase(torch, seq_model, sessions)
        seq_ann = sequential_ann_phase(torch, seq_model, sessions)
        del seq_model, sessions
        tt_model, tt_algo, tt_td, tt_train_launches = twotower_train_phase(torch, home)
        tt_serve_launches = twotower_serve_phase(torch, tt_model, tt_algo)
        tt_ann = twotower_ann_phase(torch, tt_model, tt_algo)
        rng = np.random.default_rng(23)
        b2_rows = [b2_times(torch, *encoder_qkv(torch, tt_model, rng.integers(0, 138_000, b)), label)
                   for b, label in ((4096, "two-tower training"), (64, "two-tower serving"))]
        del tt_model
        twotower_step_split(torch, tt_td)
        del tt_td
        similar = similarproduct_phase(torch)
        similarproduct_quality_phase(torch)
        similar_ann = similarproduct_ann_phase(torch, home)
        ecommerce = ecommerce_phase(torch, home)
        classification_phase(torch, home)
    except BaseException as exc:
        report_failure(exc, home)
        raise
    finally:
        remove_work(home)
    kernel["launches_by_path"] = {"als_train": launches, "sequential_train": seq_launches,
                                  "als_train_rank_160": rank160_launches,
                                  **rest["launches"], **sql_es["launches"], **similar["launches"],
                                  **ecommerce["launches"], **recuser["launches"],
                                  **offline["launches"], **foldin_launches,
                                  **registry["launches"], **similar_ann["launches"],
                                  **jsonl["launches"], **variants["launches"],
                                  **ranks["sharded_als"]["launches"], **ranks["sharded_cli"]["launches"]}
    kernel["launches"] = sum(kernel["launches_by_path"].values())
    kernel["other_shapes"] += (rest["rows"] + sql_es["rows"] + eval_rows + foldin_rows + rank160["rows"]
                               + similar["rows"] + similar_ann["rows"] + [grid_row]
                               + ranks["sharded_als"]["rows"])
    block = next(e for e in attention if e["name"] == "attention_block")
    block["launches_by_path"].update(twotower_train=tt_train_launches,
                                     twotower_serve=tt_serve_launches,
                                     twotower_ann=tt_ann["attention_block_launches"],
                                     **seq_bp["launches"]["attention_block"],
                                     **seq_ann["launches"]["attention_block"],
                                     **ranks["twotower_parallel"]["launches"],
                                     **ranks["twotower_sharded_cli"]["launches"])
    block["launches"] = sum(block["launches_by_path"].values())
    block["other_shapes"] = b2_rows + [r for r in wide_rows if r["kernel"] == "attention_block"] \
        + [r for r in seq_bp["rows"] if r["kernel"] == "attention_block"] + ranks["twotower_parallel"]["rows"]
    flash = next(e for e in attention if e["name"] == "flash_attention")
    flash["launches_by_path"].update(**seq_bp["launches"]["flash_attention"],
                                     **seq_ann["launches"]["flash_attention"])
    flash["launches"] = sum(flash["launches_by_path"].values())
    flash["other_shapes"] = [r for r in wide_rows if r["kernel"] == "flash_attention"] \
        + [r for r in seq_bp["rows"] if r["kernel"] == "flash_attention"]
    print(json.dumps({"kernels": [kernel, *attention]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    # a crash of this process or of any it starts (they inherit the
    # environment) leaves its stack on stderr
    faulthandler.enable()
    os.environ["PYTHONFAULTHANDLER"] = "1"
    if sys.argv[1:2] == ["--rank-phase"]:
        sys.exit(rank_phase_main(sys.argv[2:]))
    sys.exit(main())
