#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed N]

Phases (any failure raises, the exit code is non-zero and no result line
is printed). A stall sentinel, a thread of this process, sleeps 50 ms
again and again; every phase's ``phase <name>: <s> s`` line and every
failed check report the longest overshoot of one sleep in that phase, so
that a miss says whether this process or the host stalled:

1. Device report: torch, CUDA, the card's name and power limit.
2. Build, through the release image's build step
   (``at2_node_tpu_torch/prebuild.py``): the CUDA verify kernel and the two
   RLC kernels (nvcc, sm_90a, always rebuilt), the native host prep and
   the native message-plane ingest (g++), all from the sources in this
   checkout, built side by side and each loaded; each kernel's
   registers, stack frame and spill bytes (the RLC lanes kernel's for each
   layout's instantiation) are read from ptxas's report. Phase 3 starts
   once the verify kernel is built, while the RLC kernels still build.
3. Kernel vs plain: about 1,000 signed transfers plus the RFC 8032 TEST 1
   vector and eight tamper classes, tiled into batches of every bucket the
   main path launches (65,536, 8,192, 4,096, 1,024, 256 and 64 lanes), a
   ragged 1,000 and a 77 (a partial last bitmask byte). On every batch the
   kernel's bitmask must equal the plain PyTorch version's bitmask,
   computed on the card, and the expected verdicts: 0 mismatches. Both are
   timed with CUDA events.
3b. RLC kernels vs plain: at the same shapes, and at the most lanes one
   wave of the split layout holds and one block more (the crossover of
   ``cuda_rlc.choose_layout``), three batches each of phase 3's valid
   lanes with ~2% of every class that stays out of the equation (high S,
   bad lengths, padding, an R with an 8-torsion component: code 0), then
   also of every rerouted class (a non-canonical or x = 0 key, a key with
   an 8-torsion component: code 2), then also one tampered lane. On every
   batch ``rlc_packed`` and each layout of the lanes kernel launched apart
   (whole and split), each followed by the fold: the codes and eq_ok must
   equal the expected ones (eq_ok True without the tampered lane, False
   with it) and, on the first and the third batch (since PR 17, to keep a
   call under 700 s), the plain version's on the card; the fold must equal
   the plain fold on the lanes kernel's own partial points, and, on
   partial points that do not vanish, the known answer; the composed
   verdicts (the codes where eq_ok holds and no lane has code 2, else the
   verify kernel) must equal the verify kernel's bitmask and the expected
   verdicts. Each layout, the fold (and the one-block fold it replaced),
   the verify kernel on the same rows and the plain version are timed
   with CUDA events.
3c. The certificate (BASELINE config 4, n = 64): ``aggregate_verify`` on
   the card on a clean certificate and on one with a tampered
   attestation must equal the verify kernel's all-valid verdict, and
   ``verify_certificate`` the verify kernel's verdicts; both timed.
4. Main path, twice, 16 concurrent callers ``verify_many`` 70,000 items
   through ``make_verifier("cuda")`` after ``warmup()``:
   - stress: the node's default verifier table with the bucket ladder and
     a queue bound raised so the backlog coalesces into the 65,536 bucket;
     every verified transfer is then committed through
     ``Accounts.transfer`` and checked against a python-int replay;
   - node default: what a node's ``[verifier]`` table gives, one 256-lane
     bucket and a queue bound of 4,096.
   Every verdict is checked, the kernel's launch count (set to 0 just
   before each run) must rise, and every shape a run launched must be one
   that phase 3 checked.
5. The broadcast plane, twice: four port nodes in this process, each with
   its own mesh over encrypted TCP on 127.0.0.1, ``Broadcast`` (16
   workers, thresholds of all 3 peers), ``make_verifier("cuda")`` at the
   node's default [verifier] table and ``Accounts``; 16 seeded clients,
   client c submitting to node c mod 4, about 2% of the slots with a
   tampered twin. Run A, the batched plane (the node default: slots of at
   most 256 entries, a 5 ms window), 512 transfers per client (cut from
   1,024); run B,
   the per-transaction plane, 64 per client. Each node commits what it
   delivers, retrying a transfer until its predecessor has committed.
   Checks: every valid transfer commits on all four nodes, the ledgers
   equal each other and the python-int replay, no tampered twin commits,
   every verifier is on the card, dispatched batches and flushed only
   256-lane buckets, the kernel's launch count (set to 0 just before each
   run) equals the flushes, and ``invalid_sig`` counts the tampered twins.
   The four nodes share one process and one GIL: the rate is a floor.
6. The node service, twice: four ``server run`` processes, configured
   by ``server config new`` and ``config get-node`` with ``[verifier]
   kind = "cuda"`` at the node default table, each in its own process on
   the card (the kernel built in phase 2 is loaded, not rebuilt); 16
   seeded clients, client c talking to node c mod 4 over gRPC through
   the port's ``Client``. Run A: ``send_asset_many`` (SendAssetBatch),
   512 transfers per client (cut from 1,024); run B: unary ``send_asset``, 64 per
   client, with 16 tampered twins sent first. A run's window ends when
   every node's committed count (one /healthz GET per node every 25 ms)
   has grown by the run's transfers; every client's ``GetLastSequence``
   on every node is checked once after it. Checks: every valid
   transfer commits on every node (``GetLastSequence`` and
   ``GetBalance`` of every account equal the python-int replay), every
   tampered twin is refused with INVALID_ARGUMENT, each node's
   ``/metrics`` shows ``audit_divergence`` 0 and ``rejected_at_ingress``
   equal to the twins refused there, each verifier dispatched batches
   and launched the kernel once per batch (the process's launch count in
   the ``/statusz`` build block, read before and after each run; a
   ``server run`` process holds one verifier), each build block
   names the card, and every server exits 0 on SIGTERM. Between the
   runs, one grpc-web ``SendAsset`` from a fresh account goes to node 0's
   RPC port as the browser wallet sends it (binary mode, one HTTP/1.1
   POST, the request in one ``net/webmux`` frame): grpc-status 0, CORS
   allow-all, the transfer committed on every node (the recipient's
   balance read back from each) and node 0's verify kernel launched.
7. The node service on the RLC route (run right after phase 6; phase 6's,
   7's and 10's nets start side by side): phase 6's net with ``[verifier]
   mode = "rlc"`` (every other key at its default); run B sends 16
   transfers a client. Phase 6's checks, and on each node over each run:
   every batch went through RLC, the RLC kernels launched once a batch,
   the verify kernel once a fallback, and a node that refused a twin fell
   back at least once.
8. BASELINE config 5, the device pool (``parallel/pool.py``), on one card:
   8a. phase 3's batches at every shape, with tampered lanes on both sides
       of every shard seam, through pools of 1, 2 and 4 shards on cuda:0
       (each shard on its own streams): the pool's verdicts and bitmask
       must equal the verify kernel's, the plain version's on the card and
       the expected ones, and ``verify_and_count``'s count their popcount;
       the whole pool launch (uploads, kernels, copies back) is timed with
       CUDA events at 4,096 and 65,536 lanes beside the kernel alone.
   8b. the 1M replay (``tools/scale_demo.py::_phase_replay``): 1,048,576
       signatures through ``verify_batch_sharded`` on the pool of 1, in
       4,096-lane buckets; every one must verify.
   8c. 32 nodes share one pool (``_phase_net``): ``[verifier] kind =
       "pool"``, batch_size 4,096, max_delay 10 ms; 32 in-process nodes,
       thresholds 21 (2f + 1, f = 10), 32 clients x 2 transfers (cut from 4) through
       ``tools/loadgen.py``; every transfer must commit on every node,
       every ledger equal the python-int replay, and the kernel launch once
       a shard a batch. The open-file limit is raised to its hard limit
       first (the net holds ~2,000 sockets), and the phase fails below it.
   8d. the entry (``entry.entry()``'s function on its example arguments)
       and ``dryrun_multichip(4, devices=["cuda:0"] * 4)``.
9. The sharded broadcast plane and the durable store (BASELINE config 3,
   run right after phase 10; 9a's and 9b's nets start side by side, 9c's
   after 9b's has stopped): phase 6's net and clients (the same seed),
   run A at a quarter of its count a client (128 transfers, the cut that
   pays for phase 13), with ``[plane] shards = 2`` and ``[store] dir`` (a directory a
   node, ``flush_interval = 1.0``), the reference's rings (4,096 slots of
   1 KiB); ``df -B1 /dev/shm`` is printed first, and the phase fails if
   the rings do not fit its free space.
   9a. ``executor = "thread"``: the owner's bulk ``verify_many`` sends
       admission's and the plane's signatures to the kernel.
   9b. ``executor = "process"``: each shard a spawn worker that verifies
       its plane signatures on the host, as in the reference; only
       admission's reach the kernel. Each server has its two workers, no
       worker maps libcuda or libtorch (every server maps libcuda), and
       ``nvidia-smi --query-compute-apps=pid`` lists none of them.
   Each of 9a and 9b: phase 6's checks of run A (the replay on every node,
   a kernel launch a batch, the card in the build block), the plane block
   (two shards, no crashed worker), ``plane_shard_effects_dropped`` 0,
   the store flushed, and committed tx/s printed beside phase 6's.
   9c. 9b's config at thresholds of two peers (f = 1) with a quarter of
       run A's traffic: the first half of it, but for its last 8
       transfers a client, goes to every node and into node 0's
       segments; those last transfers go to nodes 1-3, and node 0 is
       killed (SIGKILL) before its store's next flush, so what it
       committed of them lies in its WAL alone (which must hold records).
       Its shard workers must exit and its rings leave ``/dev/shm``. The
       second half goes to nodes 1-3, node 0 restarts from its TOML and
       store directory (its recovery states polled on ``/statusz`` until
       ``live``; the store is read before the RPC port binds, so the
       recovery block counts the segments loaded and the WAL records
       replayed, which must be all its WAL held), one more transfer a
       client goes to every node, and every node, node 0 included, must
       equal the python-int replay. The verify kernel's launches are
       counted from a snapshot after each node's warm-up (node 0's after
       its restart went live): a launch a batch, at least one a node.
   Every server of every run exits 0 on SIGTERM and leaves no ring in
   ``/dev/shm``.
10. Finality certificates and the broker ingress tier (BASELINE config 3,
   run right after phase 7): phase 6's net with ``[finality] enabled =
   true`` (``audit_every`` at its default, 256).
   10a. Run A (the same seed and size). Then, within 10 s,
       ``Client.wait_final`` through node 1 returns a certificate that
       an f+1 ``LightVerifier`` of the four sign keys (read from the
       TOMLs) accepts and that reaches the node's frontier; every node's
       ``/certz`` chain is polled until its newest certificate covers the
       node's commit frontier (the certificate lag is printed). Checks:
       phase 6's checks of run A; on every node a non-empty chain, its
       newest certificate at the node's committed count, the four newest
       certificates at the same commits with one preimage,
       ``verify_chain`` ok under the f+1 and the full light client and
       refused by the full one (and by one that needs every signer) once
       a co-signature byte is flipped, ``finality_equivocation`` 0.
   10b. ``tools/broker.py`` as a process in front of node 0
       (``--max-entries 1024``); ``tools/loadgen.py`` ``run_load(...,
       broker=True)`` with 16 seeded clients x 256 transfers through it,
       then 16 transfers with a flipped signature byte through the
       broker's gRPC surface. Checks: every node commits the 4,096 and
       equals the python-int replay, no tampered transfer commits, node
       0 refuses the 16 at ingress, took distilled batches and launched
       the verify kernel a batch (as every node did), the broker
       forwarded 4,096 + 16 entries and its ``/healthz`` says ``role =
       broker``, ``trace_collect.stitch`` over the four nodes' and the
       broker's ``/tracez`` joins transfers across the broker hop, the
       chains verify again, and ``tools/top.py --once`` over the nodes
       and the broker exits 0 with its ``final`` column. Every server
       exits 0 on SIGTERM, the broker 0 on SIGINT.
11. The deterministic simulator (``at2_node_tpu_torch/sim``: 11a, 11b and
   11d on four of the host's cores beside phases 2-3c, 11c after phase 8)
   through the port's five CLIs, each a subprocess started
   without PYTHONHASHSEED (the tools pin it), four at a time; every hash
   must equal the reference's in ``SIM_GATES``, printed by the JAX
   package's CLIs for the gates of its ``scripts/ci.sh``. The sim runs on
   the host CPU and launches no kernel.
   11a. The determinism, byzantine-broker, restart and salting campaigns,
       twice each (exit 0, no failing episode, the two hashes alike), the
       50-episode campaign once, and ``planted_breach_episode(20260805)``
       with scripts/ci.sh's artifact check (4 flight-recorder dumps, the
       offending transfer stitched across nodes with its stragglers).
   11b. The smoke grid twice and the full 18-cell grid at seed 1 once (no
       cell breaching its SLO; the full grid's hash is the one
       BENCH_SCENARIOS.json banks); both WAN replays with the [wan]
       levers twice each (every transfer committed, the reference's p99,
       the steady cell's under 1,000 ms); the overload A/B twice (the
       uncontrolled arm breaches its SLO, the controlled arm holds it).
   11c. Node 0's ``/capturez`` from the end of 10a (the last 512 inbound
       frames, signatures checked by the verify kernel) replayed into a
       fresh 4-node sim by ``capture_replay --repeat 2 --json``: one
       verdict hash both times, no invariant violation; the messages in
       the captured frames counted by kind, with a payload, an echo and a
       ready (per transfer or per batch) and a co-signature (kind 16)
       among them.
   11d. ``bench_finality`` at its defaults: the production block and the
       wire bytes equal the reference's; the light-client verify rate is
       printed as the host CPU's, beside the card's name and power limit.
   One ``{"sim": {...}}`` line gives the hashes, the seconds of each run
   and of the phase.
12. The measurement tools (``at2_node_tpu_torch/tools``, run after phase
   11), every row into a temporary directory:
   12a. ``verify_bench`` at its three buckets (65,536, 8,192, 1,024 lanes,
       1 trial, cut from 3): each bucket's kernel bitmask must equal the plain
       version's on the card and the expected verdicts (all valid); the
       tool's ``roofline`` block (``ops/roofline.py`` on the 65,536-lane
       device-only rate) must give ``roofline_pct`` in (0, 105], printed
       beside phase 3's time and bound at that bucket and the card.
   12b. ``aggregate_bench --cert-route`` at n = 64: the verify kernel's
       verdicts on a clean and a tampered certificate, and the RLC
       kernels' verdicts and eq_ok, which must equal phase 3c's; then the
       default host grid at ``--rounds 1``.
   12c. ``plane_bench`` with scripts/ci.sh's arguments, every node on the
       card's verifier: ``--compare-obs``, ``--smoke-profile`` (the loop,
       and 2 shards under the thread and the process executor; every
       phase counter must tick) and ``--shards-grid 1,2 --cores 2`` under
       each executor; the
       overhead and the speedup are printed beside the reference's 5%
       and 1.5x, not gated on.
   12d. ``e2e_bench``'s two arms at 16 clients x 12 unary transfers (a
       quarter of its default 50, the cut that pays for phase 13):
       four ``server run`` processes on the host verifier, and
       four in-process nodes sharing one ``CudaBatchVerifier``), then
       ``--compose``; every transfer must commit.
   12e. Four ``server run`` nodes with ``kind = "cuda"``: 16 clients send
       SendAssetBatch chunks while ``profile_collect --duration 2.5`` (cut from 5)
       profiles every node (its table printed a node); every transfer
       must commit and equal the replay; then ``incident --now`` as a
       subprocess, its bundle rebuilt twice from the files it wrote, with
       its hash.
   12f. ``bench_durability`` at its defaults (100,000 accounts, 64 shards),
       the restarted node on the card; its ``ok`` must hold.
   12g. ``regress --dir`` over the phase's rows (12a's and 12d's verify
       grids, at the same trials, are judged against each other): no
       schema error; a regression is printed, not gated on.
   One ``{"tool": ...}`` line a tool; the kernels line counts phase 12's
   launches with the earlier phases'.
13. The served overload A/B (run after phase 12): two arms, each on a
   fresh net of four ``server run`` processes with ``kind = "cuda"`` as in
   phase 6, arm off with no ``[overload]`` table, arm on with ``[overload]
   enabled = true`` (every other key at its default); every node with
   ``[observability] trace_cap`` and ``trace_done_cap`` of 65,536, node 3
   also with ``profile_dir``. The same seed, keys and schedule in both:
   40 steady clients register (through node c mod 4, one committed
   transfer each; every node's ``directory_size`` counts them and a
   ``Register`` of each key at every node answers its id), then each
   sends a unary ``SendAsset`` every 100 ms (400 tx/s), round-robin over
   the nodes; 3 s in, 80 fresh clients start within milliseconds of each
   other, each sending 128 transfers (signed beforehand) in
   ``SendAssetBatch`` chunks of 64, chunk k of client c to node (c + k)
   mod 4, a chunk only once the one before it was acknowledged, each call
   through ``RetryPolicy(budget=8)`` (a client whose budget runs out
   stops and its rest counts as refused); the steady tier runs on for 10 s
   after the crowd's end (in arm on, until every node is back at level
   0). ``/healthz`` of every node is polled at 5 Hz and its ``/statusz``
   pressure block at 2 Hz throughout, by a spawned process of its own
   (phase 14's and 15's polls too). Checks, each arm: (1) every
   acknowledged transfer commits on all four nodes, the ledgers equal the
   python-int replay and each steady sender's sequences are contiguous;
   (2) arm on: every refusal is RESOURCE_EXHAUSTED with a
   ``retry_after_ms`` in [retry_after_ms, retry_after_max_ms]; (3) arm
   off: no refusal, no overload shed, pressure and level 0 on every node;
   (4) ``admission_throttled`` and ``rejected_at_ingress`` 0; (5)
   ``slots_undelivered`` 0 at the end and no ``/metrics`` drop counter
   moved; (6) every ``/healthz`` answer 200 with ``ok`` or ``overloaded``,
   at 4 Hz or faster; (7) arm on: every node back at level 0 within 15 s
   of the crowd's end; (8) every node's verify kernel launched; and node
   3's trace (``at2-node-<pid>.trace.json``, written at SIGTERM) holds as
   many ``ed25519_verify_kernel`` events as its launch count grew. Printed
   a arm: the steady tier's acknowledgement-to-commit p50/p99 (the last
   node's commit stamp on ``/tracez``), committed tx/s and Jain's index;
   the crowd's committed, re-sent and refused transfers; a node, the
   overload sheds, peak pressure and level, the signal that led, seconds
   back to level 0, the verifier's queue peak and queue-wait p50/p99, K1
   launches and busy share; node 3's K1 busy share from the trace's own
   kernel durations beside the event-timed one, and the device's idle
   share of the trace window. Whether arm on held the reference's bar
   (the steady p99 below arm off's, Jain's index >= 0.8) is printed, not
   gated on.
14. The reference's overload A/B bench served (run after phase 13): its
   cells (``sim/scenarios.py::run_overload_ab``: flash_crowd and
   hot_account, each uncontrolled then controlled) on four ``server run``
   nodes with ``kind = "cuda"`` a net, at the cell's thresholds of two
   peers (f = 1), in place of its modeled verifier.
   flash_crowd's uncontrolled net (no ``[overload]`` table) starts
   first, and C_tx is measured on it: as many fresh keys as the crowd
   offer it 2,500 unary ``SendAsset`` a second for the burst's window
   (1.2 s: 3,000), open loop, more than any net of the card takes, in
   the shape of the crowd's burst (uniform times and nodes), and C_tx is
   the rate at which their last node's commits came between the 10th and
   the 90th percentile, beside the signatures the four verifiers checked
   a committed transfer; the net drains before its arm. Each workload's
   schedule is the reference cell's (its seed derivation, the port's
   generator; 120 clients, a crowd of 80, 12 s; hot_account's cut to
   3 s) at ``n_tx = round(run length x C_tx / capacity_frac)``; the
   other three nets (the controlled ones with ``overload_objectives(cap)``
   written key by key, cap: the per-node verify rate at C_tx) start
   together once it is measured, and every net stays up through both
   workloads' arms. Every node has trace, done and recorder caps of
   ``max(4096, 4 n_tx)``, the measured net's at the n_tx of the offered
   rate. The steady tier registers (every node's
   ``directory_size`` counts it, ``Register`` answers its id at every
   node); eight spawned sender processes, two a node, send each event as
   one unary ``SendAsset`` at its offered time through
   ``RetryPolicy(budget=4)``. Gated, after all four cells printed: (a)
   every expected transfer (acknowledged, every earlier sequence of its
   sender acknowledged) commits on every node, each node's ledger equal
   to the replay of the ledger's rule in the node's own commit order (its
   completed-trace ring), ``slots_undelivered`` 0, no drop counter moved,
   every server exits 0, and a call fails only as a shed
   (RESOURCE_EXHAUSTED) or as one the node's gRPC server never took up,
   cancelled by grpc after 30 s (CANCELLED, at least 29.5 s after it went
   out); (b) the uncontrolled arms shed nothing: no RESOURCE_EXHAUSTED,
   no ``overload_shed_*``, pressure 0; (c) the controlled flash_crowd arm
   sheds on some node, every refusal RESOURCE_EXHAUSTED with a hint in
   [250, 3000] ms, and RetryPolicy retries, each no sooner than 0.75 x
   its hint after the refusal (a retried transfer committing held on the
   card only sometimes: a tracked strict check, printed every run; so
   is a second one, level 2 first read before the crowd's last admission
   on every node, with each node's margin);
   (d) K1 launches on every node in every arm; (e) the p99 of a send's
   lateness against its offered time is under 0.5 s. A row a cell (the reference cell's keys,
   ``card``, C_tx, sigs a transfer, K1 launches, the controller's peak,
   burn, seconds to level 0) goes to
   ``at2_node_tpu_torch/build/bench/overload_ab_served.json``; the
   reference's bar per workload (uncontrolled breaches latency_slo_ms,
   controlled holds it with fairness >= 0.8) is printed, not gated on.
15. The served ``[wan]``, ``[checkpoint]`` rejoin and ``[membership]``
   paths (run after phase 14).
   15a. Two nets of four ``server run`` nodes with ``kind = "cuda"`` as in
       phase 6, at thresholds of two peers (f = 1), started together, each
       ``[[nodes]]`` entry with its node's region hint (nodes 0-1 "eu",
       2-3 "us"), every node with trace caps of 16,384, node 3 with
       ``[checkpoint]`` (1 s) and ``[catchup] after = 0.5, window = 1.0``;
       arm off with no ``[wan]`` table and ``tools/broker.py`` in front of
       node 0, arm on with ``overlap_ready``, ``region_fanout``,
       ``verify_ahead`` and ``eager_broker`` on, each node's own region,
       and the broker with ``--eager``. Each arm, the same seed: 16
       clients register (one committed transfer each), then send a unary
       ``SendAsset`` each every 100 ms for 3 s (cut from 8), round-robin over the nodes
       (then node 0's ``/capturez`` is read); 4 x 16 lone transfers
       through the broker (``loadgen --broker``); one ``SendAssetBatch``
       burst of 16 x 128 (cut from 256). ``/healthz`` polled at 5 Hz throughout. Gated:
       every transfer committed on all four nodes and every ledger equal
       to the python-int replay, every paced and broker transfer stamped
       committed on every node's ``/tracez``, ``broker_eager_flushes`` > 0
       on and 0 off, every ``/healthz`` poll answered and a non-200 only
       as a 503 for an SLO breach, K1 launches on every node; once both
       arms ran, arm on's share of node 0's captured Echo frames (decoded
       with ``messages.parse_frame``) that carry their Ready above arm
       off's and above 0, and more Readies sent before their echo quorum
       (the nodes' phase markers, ``trace_collect.phase_overlap``) on
       than off. Printed: each arm's paced ack-to-commit p50/p99 (the
       latest of the four commit stamps), the broker tier's (broker_rx
       to the last commit), the burst's committed tx/s.
   15b. On arm on's net: node 3 stops (SIGTERM; its snapshot must equal
       the replay), the burst's clients commit 128 more each (cut from 256) on nodes
       0-2 (before them a client at each re-registers a key the node
       assigned until its sender to node 3 has failed, after them until
       its mesh has dropped as many messages as its queues held: the tail
       is not replayed on redial, as after a long absence), and node 3
       restarts from the same TOML. Gated: recovery
       states catchup then ``live`` within 120 s, every tail transfer
       applied by catch-up (``catchup_applied``), ``catchup_preverified``
       > 0, K1 launches while it caught up, every ledger equal to the
       replay. The reference's catch-up runner can end with the node
       behind (ROADMAP section 3): whether every tail sender was caught
       up when ``live`` came is a strict check, printed, not gated; when
       it missed, one more transfer of each tail sender goes to every
       node and kicks a new catch-up. Printed: seconds to ``live``, the
       pre-verified share, the polls that read a nonzero verifier queue.
   15c. Four in-process port nodes sharing one ``make_verifier("cuda")``,
       each with ``[membership] admin_public`` and a 1 s grace: a round
       commits on all four; an admin-signed ``ConfigTx`` for epoch 1
       (remove node 3, thresholds 2) goes in at node 0 through
       ``_on_config_tx(None, tx)``; every node must reach epoch 1 with
       thresholds (2, 2), a round commit on nodes 0-2, ``evicted_final``
       reach 1 on nodes 0-2; epoch 1 again must change nothing and an
       epoch-5 ConfigTx count ``rejected`` and change nothing else; a
       third round commits on nodes 0-2, their ledgers equal to the
       replay; K1 launches. Every server exits 0 on SIGTERM, each broker
       0 on SIGINT.
16. The deploy unit's runbook (``deploy/README_torch.md``; run right
   after phase 10, its net started beside phase 6's, 7's and 10's): four
   nodes, each configured by ``bin/torch/server config new`` (``[verifier]
   kind = "cuda"``) with every peer's ``config get-node`` fragment and a
   ``[checkpoint]`` (1 s) under its own data directory appended, each
   started by ``deploy/docker-compose.torch.yml``'s own entrypoint (``/bin/sh
   -c "exec python -m at2_node_tpu_torch.cli.server run < node.toml"``,
   the node's TOML in the mount's place; there is no docker). Two wallets
   from ``bin/torch/client config new`` send 2 transfers each to each
   other through ``bin/torch/client send-asset`` while 16 seeded clients
   send 64 each (SendAssetBatch). Gated: every transfer commits on every
   node and every ledger equals the python-int replay; each node's verify
   kernel launched (its ``/statusz`` build block, which names the card);
   down: SIGTERM to all four at once, each exits 0 within the unit's 30 s
   ``stop_grace_period`` and its checkpoint, written at its stop, equals
   the replay; up again from the same configs and data directories: every
   node walks ``catchup`` to ``live`` within 120 s, ``bin/torch/client
   get-balance`` reads back each wallet's balance and every node's ledger
   equals the replay; one more ``send-asset`` then commits on all four,
   each node's kernel launching. Printed: the seconds to each RPC port, to
   ``live``, and of the down.
17. One JSON line describing the kernels (their times and bound at every
   shape, every main-path run, the ptxas figures), then the result line
   ``{"ok": true, "device": {...}}``.

Runs only on a CUDA device and only from a checkout of the repository.
"""

from __future__ import annotations

import argparse
import asyncio
import http.client
import json
import os
import re
import subprocess
import sys
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# every bucket of the ladder the main path launches, a ragged batch (1,000)
# and a partial last bitmask byte (77)
KERNEL_LANES = (65536, 8192, 4096, 1024, 1000, 256, 64, 77)
MAIN_ITEMS = 70_000
MAIN_CALLERS = 16
CALLER_CHUNK = 1024
N_KEYS = 64
SEQS_PER_KEY = 16
TAMPER_SHARE = 0.02
TAMPER_CLASSES = (
    "r_flip", "s_flip", "msg_flip", "high_s", "noncanonical_y",
    "x0_sign", "wrong_len", "padding",
)

# phase 5: BASELINE config 3's net (4 nodes, 16 clients, batch_size=256)
NET_NODES = 4
NET_CLIENTS = 16
NET_PER_CLIENT_BATCHED = 512  # run A (phases 5-7, 9, 10), cut from 1,024 to keep a call under 700 s
NET_PER_CLIENT_PER_TX = 64
NET_DEADLINE_S = 240.0
# phase 6: the same net as `server run` processes; run B's tampered twins
# stay far under the admission fail bucket (64 per 10 s per source)
NODE_TAMPERED = 16
# a run's window ends at the /healthz poll that sees the last node's
# committed count reach its target: one small GET per node per period
NODE_POLL_S = 0.025

# phase 3b: lane classes that stay out of the RLC equation (code 0) and
# that are rerouted to the exact check (code 2)
RLC_OUT = ("high_s", "wrong_len", "padding", "r_torsion")
RLC_REROUTE = ("noncanonical_y", "x0_sign", "a_torsion")
# phase 3c: BASELINE config 4, a quorum certificate of n = 64 attestations
CERT_N = 64
# phase 7: run B's unary transfers a client
NODE_RLC_PER_UNARY = 16
# phase 8: pool sizes on one card, the shapes its launch is timed at, the
# 1M replay, and the 32-node net of BASELINE config 5 (SCALE_r05's round-5
# shape: 32 clients x 4 transfers)
POOL_SHARDS = (1, 2, 4)
POOL_TIMED_LANES = (4096, 65536)
REPLAY_SIGNATURES = 1 << 20
REPLAY_BUCKET = 4096
SCALE_NODES = 32
SCALE_CLIENTS = 32
SCALE_PER_CLIENT = 2  # 8c, cut from 4 to keep a call under 700 s
SCALE_POOL_BATCH = 4096
SCALE_DEADLINE_S = 240.0

RFC8032_TEST1 = (
    "9d61b19deffd5a60ba844af492ec2cc44449c5697b326919703bac031cae7f60",
    "d75a980182b10ab7d54bfed3c964073a0ee172f3daa62325af021a68f707511a",
    "e5564300c360ac729086e2cc806e828a84877f1eb8e5d974d873e065224901555fb8821590a33bacc61e39701cf9b46bd25bf5f0595bbe24655141438e7a100b",
)


SENTINEL_TICK_S = 0.05  # the stall sentinel's sleep


class StallSentinel:
    """A daemon thread of this process that sleeps SENTINEL_TICK_S again
    and again and keeps the longest overshoot of one sleep since the last
    ``take``: a long one says that this process (its GIL) or the whole
    host stalled."""

    def __init__(self) -> None:
        import threading

        self.worst = 0.0
        threading.Thread(target=self._run, name="stall-sentinel", daemon=True).start()

    def _run(self) -> None:
        while True:
            t = time.perf_counter()
            time.sleep(SENTINEL_TICK_S)
            self.worst = max(self.worst, time.perf_counter() - t - SENTINEL_TICK_S)

    def reading(self) -> str:
        return (f"stall sentinel: longest overshoot of a {1e3 * SENTINEL_TICK_S:.0f} ms sleep "
                f"{1e3 * self.worst:.1f} ms")

    def take(self) -> float:
        """The longest overshoot in seconds since the last take."""
        worst, self.worst = self.worst, 0.0
        return worst


SENTINEL: StallSentinel | None = None  # main() starts it


def check(cond: bool, what: str) -> None:
    if not cond:
        if SENTINEL is not None:
            what += f" ({SENTINEL.reading()} in this phase, load average {os.getloadavg()})"
        raise RuntimeError(f"chip_smoke: {what}")


def log(*args) -> None:
    print(*args, flush=True)


# -- phase 1 ---------------------------------------------------------------


def device_report(torch) -> str:
    check(torch.cuda.is_available(), "no CUDA device: this script runs only on a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"host: {len(os.sched_getaffinity(0))} cores (sched_getaffinity), load average {os.getloadavg()}")
    return card


# -- phase 2 ---------------------------------------------------------------
# the release image's build step, at2_node_tpu_torch/prebuild.py: main()
# runs its remove_kernel_libs, then its build_libs beside phase 3


# -- test material ---------------------------------------------------------


def torsion_point():
    """An extended point of order 8: [L]Q for a curve point Q off the
    prime-order subgroup."""
    from at2_node_tpu_torch.crypto import _fallback as fb
    from at2_node_tpu_torch.ops.ed25519 import L

    for y in range(2, 60):
        try:
            q = fb._pt_decompress(y.to_bytes(32, "little"))
        except Exception:
            continue  # y is not on the curve
        t = fb._pt_mul(L, q)
        if not fb._pt_equal(t, fb._IDENT):
            return t
    raise RuntimeError("chip_smoke: no torsion point found")


class Material:
    """Signed transfers (64 seeded keys x 16 sequences), the RFC 8032
    TEST 1 vector, and a pool of lanes for every tamper class."""

    def __init__(self, seed: int) -> None:
        from at2_node_tpu_torch.crypto import _fallback as fb
        from at2_node_tpu_torch.crypto.keys import SignKeyPair, verify_one
        from at2_node_tpu_torch.ops.ed25519 import L
        from at2_node_tpu_torch.types import transfer_signing_bytes

        rng = np.random.default_rng(seed)
        keys = [SignKeyPair(rng.bytes(32)) for _ in range(N_KEYS)]
        self.senders = [kp.public for kp in keys]
        self.valid: list = []  # (pk, msg, sig)
        self.transfers: list = []  # (sender, seq, recipient, amount) per valid item, or None
        for seq in range(1, SEQS_PER_KEY + 1):
            for k, kp in enumerate(keys):
                recipient = keys[(k + seq) % N_KEYS].public
                amount = int(rng.integers(1, 5000))
                msg = transfer_signing_bytes(kp.public, seq, recipient, amount)
                self.valid.append((kp.public, msg, kp.sign(msg)))
                self.transfers.append((kp.public, seq, recipient, amount))
        sk, pk_hex, sig_hex = RFC8032_TEST1
        rfc = SignKeyPair(bytes.fromhex(sk))
        check(rfc.public.hex() == pk_hex and rfc.sign(b"").hex() == sig_hex,
              "RFC 8032 TEST 1 vector does not reproduce")
        self.valid.append((rfc.public, b"", bytes.fromhex(sig_hex)))
        self.transfers.append(None)

        def crafted(a_enc: bytes):
            # A of order 1 ([h]A = identity) with R = [r]B and S = r: the
            # equation holds for any message, so only A's encoding decides
            r = int.from_bytes(rng.bytes(32), "little") % L
            big_r = fb._pt_compress(fb._pt_mul(r, fb._BASE))
            return (a_enc, b"crafted %d" % r, big_r + r.to_bytes(32, "little"))

        one = (1).to_bytes(32, "little")
        # the control: canonical y = 1, sign 0, verifies
        self.control = crafted(one)
        p_plus_1 = (fb._P + 1).to_bytes(32, "little")
        one_signed = (1 | (1 << 255)).to_bytes(32, "little")
        self.tampered: dict = {c: [] for c in TAMPER_CLASSES}
        n_pool = 24
        for j in range(n_pool):
            pk, msg, sig = self.valid[int(rng.integers(0, len(self.valid) - 1))]
            s = int.from_bytes(sig[32:], "little")
            self.tampered["r_flip"].append((pk, msg, bytes([sig[0] ^ 1]) + sig[1:]))
            self.tampered["s_flip"].append((pk, msg, sig[:32] + bytes([sig[32] ^ 1]) + sig[33:]))
            self.tampered["msg_flip"].append((pk, msg[:-1] + bytes([msg[-1] ^ 1]), sig))
            self.tampered["high_s"].append((pk, msg, sig[:32] + (s + L).to_bytes(32, "little")))
            self.tampered["noncanonical_y"].append(crafted(p_plus_1))
            self.tampered["x0_sign"].append(crafted(one_signed))
            self.tampered["wrong_len"].append(
                (pk[:31], msg, sig) if j % 2 else (pk, msg, sig[:63])
            )
            self.tampered["padding"].append((pk, msg, sig))  # valid byte zeroed later

        # 8-torsion lanes: R = [r]B + T with S = r + h a (the RLC route's
        # code 0; always rejected), and a key A' = [a]B + T (code 2: its
        # verdict depends on h mod 8), each with its expected verdict
        t = torsion_point()
        self.torsion: dict = {"r_torsion": [], "a_torsion": []}
        for j in range(2 * n_pool):
            in_key = j % 2 == 1
            a, r = (int.from_bytes(rng.bytes(32), "little") % L for _ in range(2))
            big_a, big_r = fb._pt_mul(a, fb._BASE), fb._pt_mul(r, fb._BASE)
            if in_key:
                big_a = fb._pt_add(big_a, t)
            else:
                big_r = fb._pt_add(big_r, t)
            a_enc, r_enc, msg = fb._pt_compress(big_a), fb._pt_compress(big_r), b"torsion %d" % j
            s = (r + fb._sha512_int(r_enc, a_enc, msg) % L * a) % L
            item = (a_enc, msg, r_enc + s.to_bytes(32, "little"))
            self.torsion["a_torsion" if in_key else "r_torsion"].append((item, verify_one(*item)))

    def rlc_batch(self, n: int, rng, reroute: bool, tamper: bool):
        """n lanes for the RLC kernels: ~2% of every class of RLC_OUT and,
        with ``reroute``, of RLC_REROUTE; with ``tamper`` one lane whose
        message changed (code 1: in the equation, invalid); the rest valid,
        the control among them; shuffled. Returns (items, expected codes,
        expected verdicts, padding mask)."""
        per_class = max(1, round(TAMPER_SHARE * n))
        lanes = []  # (item, code, verdict, padding)
        for c in RLC_OUT + (RLC_REROUTE if reroute else ()):
            for j in range(per_class):
                if c in self.torsion:
                    item, ok = self.torsion[c][j % len(self.torsion[c])]
                else:
                    item, ok = self.tampered[c][j % len(self.tampered[c])], False
                lanes.append((item, 2 if c in RLC_REROUTE else 0, ok, c == "padding"))
        if tamper:
            lanes.append((self.tampered["msg_flip"][0], 1, False, False))
        lanes.append((self.control, 1, True, False))
        for j in range(n - len(lanes)):
            lanes.append((self.valid[j % len(self.valid)], 1, True, False))
        lanes = [lanes[i] for i in rng.permutation(n)]
        return ([x[0] for x in lanes], np.array([x[1] for x in lanes], dtype=np.uint8),
                np.array([x[2] for x in lanes]), np.array([x[3] for x in lanes]))

    def cross_check(self) -> None:
        """The single-signature verifier agrees with the expected verdict
        of one lane of each class it can judge. Not the crafted encodings:
        OpenSSL reduces a non-canonical y mod p where RFC 8032 (and the
        batch verifier) rejects it."""
        from at2_node_tpu_torch.crypto.keys import verify_one

        check(all(verify_one(*self.valid[i]) for i in (0, 1, len(self.valid) - 1)),
              "verify_one rejects a valid lane")
        for c in ("r_flip", "s_flip", "msg_flip", "high_s", "wrong_len"):
            check(not verify_one(*self.tampered[c][0]), f"verify_one accepts a {c} lane")

    def batch(self, n: int, rng) -> tuple[list, np.ndarray, np.ndarray]:
        """n lanes, ~2% of every tamper class, the rest valid (the control
        included), shuffled. Returns (items, expected, padding mask)."""
        per_class = max(1, round(TAMPER_SHARE * n))
        items, expect, pad = [], [], []
        for c in TAMPER_CLASSES:
            pool = self.tampered[c]
            for j in range(per_class):
                items.append(pool[j % len(pool)])
                expect.append(False)
                pad.append(c == "padding")
        items.append(self.control)
        expect.append(True)
        pad.append(False)
        for j in range(n - len(items)):
            items.append(self.valid[j % len(self.valid)])
            expect.append(True)
            pad.append(False)
        order = rng.permutation(n)
        return ([items[i] for i in order], np.asarray(expect)[order],
                np.asarray(pad)[order])


# -- phase 3 ---------------------------------------------------------------


def cuda_ms(torch, fn, reps: int) -> float:
    """Device time of one call of ``fn`` over ``reps`` calls in a row, by
    CUDA events. The card first sleeps ~0.1 ms a call, so the calls are
    enqueued before the first runs: the time is the device's alone, not the
    host's launch interval, which a kernel of tens of us does not hide."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(reps * 1e-4 * 1.98e9))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_vs_plain(torch, mat: Material, rng) -> dict:
    from at2_node_tpu_torch.ops import cuda_verify, roofline
    from at2_node_tpu_torch.ops import ed25519 as v

    ceilings = roofline.card_of("cuda:0")  # the bounds' one source; raises on an unknown card

    rows_by_lanes = {}
    mismatches = 0
    max_abs_err = 0
    for n in KERNEL_LANES:
        items, expect, pad = mat.batch(n, rng)
        rows = np.empty((n, v.PACKED_WIDTH), dtype=np.uint8)
        v.fill_packed([i[0] for i in items], [i[1] for i in items], [i[2] for i in items], rows)
        rows[pad, 128] = 0  # padding lanes: a valid row with its valid byte cleared
        dev = torch.from_numpy(rows).cuda()
        kern = cuda_verify.verify_packed(dev)
        plain = v.verify_packed(dev)
        torch.cuda.synchronize()
        k_bits = np.unpackbits(kern.cpu().numpy(), count=n).astype(bool)
        p_bits = np.unpackbits(plain.cpu().numpy(), count=n).astype(bool)
        bad = int((k_bits != p_bits).sum() + (k_bits != expect).sum())
        tail = kern.cpu().numpy()[-1] & ((1 << (8 - n % 8)) - 1) if n % 8 else 0
        check(tail == 0, f"{n} lanes: bits past the last lane are not zero")
        err = int(np.abs(kern.cpu().numpy().astype(int) - plain.cpu().numpy().astype(int)).max())
        mismatches += bad
        max_abs_err = max(max_abs_err, err)
        reps = max(3, min(50, 200_000 // n))
        ms = cuda_ms(torch, lambda: cuda_verify.verify_packed(dev), reps)
        plain_ms = cuda_ms(torch, lambda: v.verify_packed(dev), 1)
        bms, by = roofline.bound_ms(n, ceilings)
        rows_by_lanes[n] = {
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "sigs_per_s": n / (ms / 1e3), "mismatches": bad,
            "valid_lanes": int(expect.sum()),
        }
        log(f"kernel vs plain {n:6d} lanes: {bad} mismatches, kernel {ms:.3f} ms "
            f"({n / (ms / 1e3):,.0f} sigs/s), plain {plain_ms:.1f} ms, bound {bms:.3f} ms ({by})")
    check(mismatches == 0, f"kernel, plain version and expected verdicts differ on {mismatches} lanes")
    return {"by_lanes": rows_by_lanes, "mismatches": mismatches, "max_abs_err": max_abs_err}


# -- phase 3b --------------------------------------------------------------


def fold_known_answer(torch, lib, consts, work, rng) -> int:
    """The fold on points that do not all vanish: the lanes kernel's
    partials of a batch are mostly the identity, so here the partials are
    random multiples of B and, last, their negated sum (eq_ok True) or
    their sum (False). Returns the mismatches against the expected eq_ok
    and the plain fold."""
    from at2_node_tpu_torch.ops import aggregate as agg
    from at2_node_tpu_torch.ops import cuda_rlc
    from at2_node_tpu_torch.ops import edwards as ed
    from at2_node_tpu_torch.ops import field as fe

    eq = torch.empty((1,), dtype=torch.uint8, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    k = rng.integers(1, 16, size=work.nparts - 1)
    (sx, sy), p, m = (0, 1), ed.point_to_ints(ed.BASE), int(k.sum())
    while m:  # [sum k]B, double and add
        if m & 1:
            sx, sy = ed.affine_add_ints((sx, sy), p)
        p, m = ed.affine_add_ints(p, p), m >> 1
    bad = 0
    for sign, want in ((-1, True), (1, False)):
        pts = np.stack([ed.BASE_TABLE[int(j)] for j in k] + [ed.point_from_ints(sign * sx % fe.P, sy)])
        work.points().copy_(torch.as_tensor(pts, dtype=torch.int32))
        cuda_rlc.launch_fold(lib, consts, eq.data_ptr(), work, stream)
        fold_plain = bool(agg.is_identity(agg.tree_reduce_points(work.points().to(torch.int64))).item())
        got = bool(eq.item())
        bad += int(got != want) + int(fold_plain != want)
    return bad


def rlc_vs_plain(torch, mat: Material, rng) -> dict:
    """Phase 3b. ``rlc_packed`` runs both kernels in the layout
    ``choose_layout`` gives; each layout of the lanes kernel and the fold
    are also launched apart, straight through the library, on every batch:
    their codes and eq_ok against the plain version, the expected ones and
    the verify kernel's composed verdicts, the fold against the plain fold
    of the lanes kernel's own partial points. Each layout, the fold over
    its partials (and over one block, the alternative it replaced) and the
    verify kernel are timed on the clean batch."""
    from at2_node_tpu_torch.ops import aggregate as agg
    from at2_node_tpu_torch.ops import cuda_rlc, cuda_verify, roofline
    from at2_node_tpu_torch.ops import ed25519 as v

    ceilings = roofline.card_of("cuda:0")
    lib = cuda_rlc.build()
    consts = torch.as_tensor(cuda_verify.lane_consts()).cuda()
    wave = cuda_rlc.split_wave_lanes(torch.device("cuda", 0))
    per_sm = {name: lib.ed25519_rlc_lanes_occupancy(layout)
              for layout, name in enumerate(cuda_rlc.LAYOUT_NAMES)}
    log(f"rlc lanes kernel: blocks an SM {per_sm}; the split layout while n <= {wave} lanes "
        f"(one wave), the whole layout past it")
    layouts = list(enumerate(cuda_rlc.LAYOUT_NAMES))
    by_lanes: dict = {"ed25519_rlc_lanes": {}, "ed25519_rlc_fold": {}}
    mism = Counter()
    max_err = {"ed25519_rlc_lanes": 0, "ed25519_rlc_fold": 0}
    stream = torch.cuda.current_stream().cuda_stream
    # every shape of phase 3, then the crossover: the most lanes one wave
    # of the split layout holds, and one block more
    for n in KERNEL_LANES + (wave, wave + cuda_rlc.LANES_PER_BLOCK[cuda_rlc.SPLIT]):
        chosen = cuda_rlc.choose_layout(n, wave)
        for kind, reroute, tamper in (("clean", False, False), ("rerouted", True, False),
                                      ("tampered", True, True)):
            items, want_codes, want_ok, pad = mat.rlc_batch(n, rng, reroute, tamper)
            cols = [list(x) for x in zip(*items)]
            rows = agg.rlc_prep(*cols, n).numpy()
            rows[pad, 160] = 0  # padding lanes: a valid row with its valid byte cleared
            k1_rows = np.empty((n, v.PACKED_WIDTH), dtype=np.uint8)
            v.fill_packed(*cols, k1_rows)
            k1_rows[pad, 128] = 0
            dev, k1_dev = torch.from_numpy(rows).cuda(), torch.from_numpy(k1_rows).cuda()

            eq, codes = cuda_rlc.rlc_packed(dev)
            bits = cuda_verify.verify_packed(k1_dev)
            # each layout apart: codes and partial points, then the fold
            outs, works = {}, {}
            for layout, name in layouts:
                outs[name] = torch.empty((n + 1,), dtype=torch.uint8, device="cuda")
                works[name] = cuda_rlc.Scratch(n, layout, dev.device)
                cuda_rlc.launch_lanes(lib, dev, consts, outs[name].data_ptr(), works[name], stream)
                cuda_rlc.launch_fold(lib, consts, outs[name].data_ptr() + n, works[name], stream)
            # the plain version runs on the clean and the tampered batch (the
            # tampered one holds every rerouted class too); the rerouted
            # batch is held against the expected codes alone, a cut that
            # keeps a call under 700 s
            plain = kind != "rerouted"
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            p_eq, p_codes = agg.rlc_graph_packed_plain(dev) if plain else (None, None)
            end.record()
            fold_plain = {name: agg.is_identity(agg.tree_reduce_points(w.points().to(torch.int64)))
                          for name, w in works.items()}
            torch.cuda.synchronize()
            plain_ms = start.elapsed_time(end)
            eq, codes = bool(eq.item()), codes.cpu().numpy()
            if plain:
                p_eq, p_codes = bool(p_eq.item()), p_codes.cpu().numpy()
            k1 = np.unpackbits(bits.cpu().numpy(), count=n).astype(bool)
            composed = (codes == 1) if eq and not (codes == 2).any() else k1
            bad = {
                "lanes": int((codes != want_codes).sum()) + (int((codes != p_codes).sum()) if plain else 0),
                "fold": int(eq != (not tamper)) + (int(eq != p_eq) if plain else 0),
                "composed": int((composed != k1).sum() + (k1 != want_ok).sum()),
            }
            for name, out in outs.items():
                apart = out.cpu().numpy()
                a_eq, a_codes = bool(apart[n]), apart[:n]
                a_composed = (a_codes == 1) if a_eq and not (a_codes == 2).any() else k1
                bad["lanes"] += int((a_codes != want_codes).sum())
                bad["fold"] += int(a_eq != (not tamper)) + int(bool(fold_plain[name].item()) != a_eq)
                bad["composed"] += int((a_composed != k1).sum())
                if plain:  # max_abs_err counts only the plain version's runs
                    bad["lanes"] += int((a_codes != p_codes).sum())
                    bad["fold"] += int(a_eq != p_eq)
                    max_err["ed25519_rlc_lanes"] = max(max_err["ed25519_rlc_lanes"],
                                                       int(np.abs(a_codes.astype(int) - p_codes.astype(int)).max()))
                    max_err["ed25519_rlc_fold"] = max(max_err["ed25519_rlc_fold"], abs(int(a_eq) - int(p_eq)))
            mism.update(bad)
            log(f"rlc vs plain {n:6d} lanes ({kind}): eq_ok {eq}, codes 0/1/2 "
                f"{[int((codes == c).sum()) for c in range(3)]}, both layouts apart and "
                f"rlc_packed ({cuda_rlc.LAYOUT_NAMES[chosen]}): {sum(bad.values())} mismatches "
                f"{dict(bad)}, " + (f"plain {plain_ms:.1f} ms" if plain else "against the expected codes"))
            if kind != "clean":
                continue
            reps = max(3, min(30, 60_000 // n))
            lanes_ms, fold_ms, bounds = {}, {}, {}
            for layout, name in layouts:
                work, out = works[name], outs[name]
                mism.update({"fold": fold_known_answer(torch, lib, consts, work, rng)})
                lanes_ms[name] = cuda_ms(torch, lambda: cuda_rlc.launch_lanes(
                    lib, dev, consts, out.data_ptr(), work, stream), reps)
                fold_ms[name] = cuda_ms(torch, lambda: cuda_rlc.launch_fold(
                    lib, consts, out.data_ptr() + n, work, stream), reps)
                bounds[name] = roofline.rlc_bounds(n, work.nparts, ceilings)
            # the fold's alternative: one block of 32 quads, each adding
            # its share of the partials in a row
            whole = works["whole"]
            one_block_ms = cuda_ms(torch, lambda: check(lib.ed25519_rlc_fold_launch(
                whole.partials, whole.nparts, consts.data_ptr(), whole.level2, whole.ticket,
                outs["whole"].data_ptr() + n, 1, 4 * cuda_rlc.FOLD_MAX_QUADS, stream) == 0,
                "one-block fold launch"), reps)
            k1_ms = cuda_ms(torch, lambda: cuda_verify.verify_packed(k1_dev), reps)
            fold_plain_ms = cuda_ms(torch, lambda: agg.is_identity(
                agg.tree_reduce_points(works[cuda_rlc.LAYOUT_NAMES[chosen]].points().to(torch.int64))), 1)
            c = cuda_rlc.LAYOUT_NAMES[chosen]
            split_ops_ms = 1e3 * n * cuda_rlc.INT32_MULADD_SLOTS_PER_LANE[cuda_rlc.SPLIT] / ceilings.int32_muladd_per_s
            for kname, ms, pms in (("ed25519_rlc_lanes", lanes_ms, plain_ms),
                                   ("ed25519_rlc_fold", fold_ms, fold_plain_ms)):
                bms, by = bounds[c][kname]
                by_lanes[kname][n] = {
                    "layout": c, "ms": ms[c], "plain_ms": pms, "bound_ms": bms, "bound_by": by,
                    "verify_kernel_ms": k1_ms,
                    "by_layout": {name: {"ms": ms[name], "bound_ms": bounds[name][kname][0],
                                         "partials": works[name].nparts} for _, name in layouts},
                }
            by_lanes["ed25519_rlc_lanes"][n]["split_work_ms"] = split_ops_ms
            by_lanes["ed25519_rlc_fold"][n]["one_block_ms"] = one_block_ms
            log(f"rlc kernels {n:6d} lanes: lanes whole {lanes_ms['whole']:.3f} ms, split "
                f"{lanes_ms['split']:.3f} ms (bound {bounds[c]['ed25519_rlc_lanes'][0]:.3f}, "
                f"{bounds[c]['ed25519_rlc_lanes'][1]}; the split layout's own work "
                f"{split_ops_ms:.3f}); fold {fold_ms['whole']:.3f} / {fold_ms['split']:.3f} ms over "
                f"{whole.nparts} / {works['split'].nparts} partials (one block: {one_block_ms:.3f}); "
                f"{c} {lanes_ms[c] + fold_ms[c]:.3f} ms against the verify kernel's {k1_ms:.3f} ms on "
                f"the same rows: RLC/per-sig {(lanes_ms[c] + fold_ms[c]) / k1_ms:.2f}x")
    check(sum(mism.values()) == 0, f"RLC kernels, plain version, verify kernel and expected results "
          f"differ: {dict(mism)}")
    # the lanes kernel answers for the codes and the composed verdicts, the
    # fold for eq_ok
    return {"by_lanes": by_lanes, "max_abs_err": max_err, "split_wave_lanes": wave,
            "blocks_per_sm": per_sm,
            "mismatches": {"ed25519_rlc_lanes": mism["lanes"] + mism["composed"],
                           "ed25519_rlc_fold": mism["fold"]}}


# -- phase 3c --------------------------------------------------------------


def certificate(torch, mat: Material, rng, by_lanes: dict) -> dict:
    """Phase 3c: ``aggregate_verify`` and ``verify_certificate`` on the card
    at n = 64, against the verify kernel; host-clock times of whole calls
    (prep, both RLC kernels and the copy back) beside the verify kernel's
    ``verify_batch``. The RLC kernels' launch counts are set to 0 just
    before and read just after."""
    from at2_node_tpu_torch.ops import aggregate as agg
    from at2_node_tpu_torch.ops import cuda_rlc
    from at2_node_tpu_torch.ops import ed25519 as v

    cert = mat.valid[:CERT_N]  # sequence 1 of each of 64 keys: 64 distinct replicas
    j = int(rng.integers(0, CERT_N))
    pk, msg, sig = cert[j]
    bad = cert[:j] + [(pk, msg, sig[:40] + bytes([sig[40] ^ 2]) + sig[41:])] + cert[j + 1:]
    cuda_rlc.launches = cuda_rlc.fold_launches = 0
    cuda_rlc.layout_launches = [0, 0]
    verdicts = {}
    for name, items in (("clean", cert), ("tampered", bad)):
        cols = [list(x) for x in zip(*items)]
        one = verdicts[name] = agg.aggregate_verify(*cols)
        per_sig = v.verify_batch(*cols)
        check(one == bool(per_sig.all()) == (name == "clean"),
              f"certificate ({name}): aggregate_verify {one}, verify kernel {per_sig.all()}")
        check(agg.verify_certificate(*cols).tolist() == per_sig.tolist(),
              f"certificate ({name}): verify_certificate differs from the verify kernel")
    launches = (cuda_rlc.launches, cuda_rlc.fold_launches)
    check(launches == (2, 2), f"certificate: RLC kernel launches {launches}, expected (2, 2)")
    layout = by_lanes["ed25519_rlc_lanes"][CERT_N]["layout"]
    by_layout = dict(zip(cuda_rlc.LAYOUT_NAMES, cuda_rlc.layout_launches))
    check(by_layout[layout] == 2, f"certificate: lanes kernel launches by layout {by_layout}, "
          f"expected 2 in the {layout} layout")
    cols = [list(x) for x in zip(*cert)]

    def host_ms(fn, reps=20):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t0))
        return float(np.median(times))

    agg_ms = host_ms(lambda: agg.aggregate_verify(*cols))
    per_sig_ms = host_ms(lambda: v.verify_batch(*cols))
    device_ms = (by_lanes["ed25519_rlc_lanes"][64]["ms"] + by_lanes["ed25519_rlc_fold"][64]["ms"])
    k1_ms = by_lanes["ed25519_rlc_lanes"][64]["verify_kernel_ms"]
    log(f"certificate n={CERT_N}: aggregate_verify agrees with the verify kernel (clean True, tampered "
        f"False); whole call {agg_ms:.3f} ms median against verify_batch's {per_sig_ms:.3f} ms; on the "
        f"card the RLC kernels take {device_ms:.3f} ms against the verify kernel's {k1_ms:.3f} ms at 64 lanes")
    return {"n": CERT_N, "verdicts": verdicts,
            "launches": {"ed25519_rlc_lanes": launches[0], "ed25519_rlc_fold": launches[1]},
            "lanes_launches_by_layout": by_layout,
            "aggregate_verify_ms": agg_ms, "verify_batch_ms": per_sig_ms,
            "rlc_device_ms": device_ms, "verify_kernel_ms": k1_ms}


# -- phase 4 ---------------------------------------------------------------


class FlushLog:
    """The verifier's flight-recorder seam: keeps every flush decision."""

    def __init__(self) -> None:
        self.flushes: list = []

    def record(self, kind: str, fields) -> None:
        if kind == "vflush":
            self.flushes.append(fields)  # (take, queue depth, bucket)


def replay_ledger(committed_items: list) -> dict:
    """The ledger rules in python ints, applied to the same transfers in
    the same order: {hex key: [last_sequence, balance]}."""
    state: dict = {}
    for sender, seq, recipient, amount in committed_items:
        s = state.setdefault(sender, [0, 100_000])
        if s[0] + 1 != seq:
            continue
        s[0] = seq
        if amount > s[1]:
            continue
        s[1] -= amount
        r = state.setdefault(recipient, [0, 100_000])
        r[1] += amount
    return {k.hex(): v for k, v in state.items()}


async def drive_verifier(label: str, items: list, expect: np.ndarray, **cfg) -> dict:
    """One main-path run: ``make_verifier("cuda", **cfg)``, ``warmup()``,
    then MAIN_CALLERS concurrent callers ``verify_many`` every item in
    chunks. The kernel's launch count is set to 0 just before the callers
    start and read just after they finish."""
    from at2_node_tpu_torch.crypto.verifier import make_verifier
    from at2_node_tpu_torch.ops import cuda_verify

    n_items = len(items)
    ver = make_verifier("cuda", **cfg)
    flushes = FlushLog()
    ver.recorder = flushes
    t0 = time.perf_counter()
    await ver.warmup()
    log(f"{label}: warmup of buckets {ver.buckets} took {time.perf_counter() - t0:.2f} s")

    async def caller(c: int) -> list:
        mine = list(range(c, n_items, MAIN_CALLERS))
        chunks = [mine[i:i + CALLER_CHUNK] for i in range(0, len(mine), CALLER_CHUNK)]
        results = await asyncio.gather(
            *(ver.verify_many([items[i] for i in ch]) for ch in chunks)
        )
        return [(i, ok) for ch, res in zip(chunks, results) for i, ok in zip(ch, res)]

    flushes.flushes.clear()
    cuda_verify.launches = 0
    t0 = time.perf_counter()
    per_caller = await asyncio.gather(*(caller(c) for c in range(MAIN_CALLERS)))
    wall = time.perf_counter() - t0
    launches = cuda_verify.launches

    got = np.zeros(n_items, dtype=bool)
    seen = np.zeros(n_items, dtype=bool)
    for pairs in per_caller:
        for i, ok in pairs:
            got[i] = ok
            seen[i] = True
    check(seen.all(), f"{label}: some items got no verdict")
    bad = int((got != expect).sum())
    check(bad == 0, f"{label}: {bad} verdicts differ from the expected ones")
    check(launches > 0, f"{label}: ran without launching the kernel")
    # the lanes each flush launched: its batch is min(take, depth) items,
    # padded to the smallest bucket that holds it
    buckets = [
        next((b for b in ver.buckets if b >= min(take, depth)), ver.buckets[-1])
        for take, depth, _ in flushes.flushes
    ]
    check(len(buckets) == launches, f"{label}: {len(buckets)} flushes but {launches} launches")
    check(set(buckets) <= set(KERNEL_LANES),
          f"{label}: flush buckets {sorted(set(buckets))} include a shape phase 3 did not check")
    stats = ver.stats()
    hists = ver.stage_histograms()
    await ver.close()
    log(f"{label}: {n_items} items from {MAIN_CALLERS} callers in {wall:.3f} s "
        f"= {n_items / wall:,.0f} sigs/s pipelined; {launches} kernel launches; "
        f"flush buckets {dict(sorted(Counter(buckets).items()))}")
    log(f"{label} verifier stats:", json.dumps(stats, sort_keys=True))
    log(f"{label} stage histograms:", json.dumps(hists, sort_keys=True))
    return {"launches": launches, "sigs_per_s": n_items / wall, "wall_s": wall,
            "buckets": buckets, "got": got}


async def main_path(mat: Material, rng) -> dict:
    from at2_node_tpu_torch.ledger.accounts import AccountModificationError, Accounts
    from at2_node_tpu_torch.ops.ed25519 import BUCKETS

    # one tile: every valid item in sequence order, the tampered items of
    # all item classes spread among them
    tile = [(it, True, tr) for it, tr in zip(mat.valid, mat.transfers)]
    for c in TAMPER_CLASSES:
        if c == "padding":
            continue
        for it in mat.tampered[c]:
            tile.insert(int(rng.integers(0, len(tile) + 1)), (it, False, None))
    work = [tile[i % len(tile)] for i in range(MAIN_ITEMS)]
    items = [w[0] for w in work]
    expect = np.array([w[1] for w in work])

    # The stress shape: the node's default [verifier] table with the
    # adaptive ladder, and a queue bound raised so a 70,000-item backlog can
    # coalesce into the 65,536 bucket (the default bound, 4,096, caps it).
    stress = await drive_verifier(
        "main path (stress)", items, expect,
        batch_size=256, max_delay=0.002, buckets=BUCKETS, max_queue=1 << 17,
    )
    check(65536 in stress["buckets"],
          f"the backlog never coalesced into the 65,536 bucket: {sorted(set(stress['buckets']))}")

    # commit every verified transfer, in item order; replays of an
    # already-committed sequence are refused by the ledger
    accounts = Accounts()
    committed, refused = [], 0
    for (it, _, transfer), ok in zip(work, stress["got"]):
        if not ok or transfer is None:
            continue
        committed.append(transfer)
        try:
            await accounts.transfer(*transfer)
        except AccountModificationError:
            refused += 1
    state = await accounts.export_state()
    check(state == replay_ledger(committed), "ledger state differs from the python-int replay")
    n_distinct = sum(1 for t in mat.transfers if t is not None)
    check(len(committed) - refused == n_distinct,
          f"{len(committed) - refused} transfers applied, expected {n_distinct}")
    check(all(state[pk.hex()][0] == SEQS_PER_KEY for pk in mat.senders),
          "a sender's last sequence is not its last signed transfer")
    log(f"ledger: {len(committed) - refused} transfers applied, {refused} replays refused, "
        f"{len(state)} accounts; balances equal the python-int replay")

    # What a node runs: VerifierConfig's defaults, one 256-lane bucket and
    # the default queue bound of 4,096, under the same flood.
    node = await drive_verifier(
        "main path (node default)", items, expect, batch_size=256, max_delay=0.002,
    )
    check(set(node["buckets"]) == {256}, f"node default flushed {sorted(set(node['buckets']))}")
    return {"stress": stress, "node_default": node}


# -- phase 5 ---------------------------------------------------------------


def port_modules():
    """The classes a node of this package is built from. Every net helper
    below takes such a namespace per node, so the same harness also builds
    nodes of another package with the same surface."""
    from types import SimpleNamespace

    from at2_node_tpu_torch.broadcast.messages import Payload, TxBatch
    from at2_node_tpu_torch.broadcast.stack import Broadcast
    from at2_node_tpu_torch.crypto.keys import ExchangeKeyPair, SignKeyPair
    from at2_node_tpu_torch.ledger.accounts import AccountModificationError, Accounts
    from at2_node_tpu_torch.net.peers import Mesh, Peer
    from at2_node_tpu_torch.types import ThinTransaction

    return SimpleNamespace(
        Payload=Payload, TxBatch=TxBatch, Broadcast=Broadcast,
        ExchangeKeyPair=ExchangeKeyPair, SignKeyPair=SignKeyPair,
        AccountModificationError=AccountModificationError, Accounts=Accounts,
        Mesh=Mesh, Peer=Peer, ThinTransaction=ThinTransaction,
    )


def free_ports(n: int) -> list:
    """n distinct free TCP ports on 127.0.0.1 (above 1024)."""
    import socket

    socks = []
    try:
        for _ in range(n):
            s = socket.socket()
            s.bind(("127.0.0.1", 0))
            socks.append(s)
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


class Node:
    """One AT2 node's broadcast plane as the node service wires it: a mesh
    over encrypted TCP, a ``Broadcast`` verifying through its own verifier,
    an ``Accounts`` ledger, the ingress batcher (``service.py``
    ``_ingest``/``_flush_batch``/``_delayed_flush``) and the commit loop
    (``_drain_to_fixpoint``: retry a transfer until its predecessor has
    committed, then release its registry binding)."""

    def __init__(self, mods, sign_kp, exch_kp, address: str, peers: list, verifier,
                 threshold=None, workers: int = 16, batching: bool = True,
                 max_entries: int = 256, window: float = 0.005) -> None:
        self.m = mods
        self.sign_kp = sign_kp
        self.verifier = verifier
        self.mesh = mods.Mesh(address, exch_kp, peers, on_frame=self._on_frame)
        self.bcast = mods.Broadcast(sign_kp, self.mesh, verifier, echo_threshold=threshold,
                                    ready_threshold=threshold, workers=workers)
        self.accounts = mods.Accounts()
        self.batching = batching
        self.max_entries = max_entries
        self.window = window
        self._buf: list = []
        self._flush_task = None
        self._batch_seq = 0
        self.batches_sent = 0
        self._pending: dict = {}  # (sender, seq) -> delivered payload awaiting its turn
        self.committed: dict = {}  # (sender, seq) -> content hash
        self.consumed: list = []  # sequences a failed debit consumed
        self.last_commit_t = 0.0
        self.want = 0
        self.done = asyncio.Event()
        self._tasks: list = []

    async def _on_frame(self, peer, frame: bytes) -> None:
        await self.bcast.on_frame(peer, frame)

    async def start(self) -> None:
        await self.bcast.start()
        await self.mesh.start()
        self._tasks.append(asyncio.create_task(self._commit_loop()))

    async def close(self) -> None:
        for t in self._tasks + ([self._flush_task] if self._flush_task else []):
            t.cancel()
        await asyncio.gather(*self._tasks, return_exceptions=True)
        await self.mesh.close()
        await self.bcast.close()
        await self.verifier.close()

    def own(self, payload):
        """The same payload as this node's package builds it (wire-equal)."""
        return self.m.Payload.decode_body(payload.encode()[1:])

    async def submit(self, payload) -> None:
        """A client's SendAsset: batched into slots of at most
        ``max_entries``, flushed on size or after ``window``; with batching
        off, one broadcast slot per payload."""
        if not self.batching:
            await self.bcast.broadcast(payload)
            return
        self._buf.append(payload)
        if len(self._buf) >= self.max_entries:
            await self._flush()
        elif self._flush_task is None or self._flush_task.done():
            self._flush_task = asyncio.create_task(self._delayed_flush())

    async def _flush(self) -> None:
        buf, self._buf = self._buf, []
        for lo in range(0, len(buf), self.max_entries):
            self._batch_seq += 1
            raw = b"".join(p.encode()[1:] for p in buf[lo:lo + self.max_entries])
            self.batches_sent += 1
            await self.bcast.broadcast_batch(self.m.TxBatch.create(self.sign_kp, self._batch_seq, raw))

    async def _delayed_flush(self) -> None:
        while True:
            await asyncio.sleep(self.window)
            await self._flush()
            if not self._buf:
                return

    async def _commit_loop(self) -> None:
        q = self.bcast.delivered
        while True:
            batch = [await q.get()]
            while not q.empty():
                batch.append(q.get_nowait())
            for p in batch:
                self._pending.setdefault(p.slot, p)
            await self._drain()

    async def _drain(self) -> None:
        """One pass in (sender, sequence) order commits every run of
        consecutive sequences; a sender stops at its first gap and waits
        for the predecessor's delivery."""
        blocked = set()
        for key in sorted(self._pending):
            if key[0] in blocked:
                continue
            p = self._pending[key]
            try:
                await self.accounts.transfer(p.sender, p.sequence, p.transaction.recipient,
                                             p.transaction.amount)
            except self.m.AccountModificationError:
                if p.sequence > await self.accounts.get_last_sequence(p.sender):
                    blocked.add(key[0])  # a gap: the predecessor is not here yet
                    continue
                self.consumed.append(key)  # a failed debit consumed the sequence
            else:
                self.committed[key] = p.content_hash()
                self.last_commit_t = time.perf_counter()
            del self._pending[key]
            self.bcast.release_entry(*key)
        if len(self.committed) + len(self.consumed) >= self.want:
            self.done.set()


async def start_net(node_mods: list, verifiers: list, rng, deadline_s: float = 60.0,
                    **node_kw) -> list:
    """Nodes on 127.0.0.1, fully meshed: keys from ``rng``, node i built
    from ``node_mods[i]`` with ``verifiers[i]``; returns once every node
    holds an encrypted channel in each direction to every peer."""
    n = len(node_mods)
    ports = free_ports(n)
    seeds = [(rng.bytes(32), rng.bytes(32)) for _ in range(n)]
    nodes = []
    for i, m in enumerate(node_mods):
        keys = [(m.SignKeyPair(s), m.ExchangeKeyPair(x)) for s, x in seeds]
        peers = [m.Peer(f"127.0.0.1:{ports[j]}", keys[j][1].public, keys[j][0].public)
                 for j in range(n) if j != i]
        nodes.append(Node(m, keys[i][0], keys[i][1], f"127.0.0.1:{ports[i]}", peers,
                          verifiers[i], **node_kw))
    for node in nodes:
        await node.start()
    t_end = time.perf_counter() + deadline_s
    while any(node.mesh.stats()["channels"] < 2 * (n - 1) for node in nodes):
        check(time.perf_counter() < t_end, f"the {n}-node mesh did not connect in {deadline_s} s")
        await asyncio.sleep(0.02)
    return nodes


def make_traffic(m, rng, n_clients: int, per_client: int, tamper_share: float):
    """Client-signed transfers of ``n_clients`` seeded wallets, sequences 1
    to ``per_client``, each to another client with an amount of 1-50 (no
    debit can fail). About ``tamper_share`` of the slots also get a
    tampered twin, submitted just before the valid one: another amount,
    one signature bit flipped. Returns (per-client submissions, valid
    transfers as (sender, seq, recipient, amount), valid content hash per
    slot, tampered content hashes)."""
    clients = [m.SignKeyPair(rng.bytes(32)) for _ in range(n_clients)]
    subs = [[] for _ in range(n_clients)]
    valid, good_hash, bad_hashes = [], {}, set()
    for c, kp in enumerate(clients):
        for seq in range(1, per_client + 1):
            recipient = clients[(c + 1 + int(rng.integers(0, n_clients - 1))) % n_clients].public
            amount = int(rng.integers(1, 51))
            if rng.random() < tamper_share:
                twin = m.Payload.create(kp, seq, m.ThinTransaction(recipient, amount + 1))
                sig = bytearray(twin.signature)
                sig[int(rng.integers(0, 64))] ^= 1 << int(rng.integers(0, 8))
                bad = m.Payload(kp.public, seq, twin.transaction, bytes(sig))
                subs[c].append(bad)
                bad_hashes.add(bad.content_hash())
            p = m.Payload.create(kp, seq, m.ThinTransaction(recipient, amount))
            subs[c].append(p)
            valid.append((kp.public, seq, recipient, amount))
            good_hash[p.slot] = p.content_hash()
    return subs, valid, good_hash, bad_hashes


async def drive_net(nodes: list, subs: list, valid: list, deadline_s: float) -> dict:
    """Client c submits its transfers, in order, to node c mod n; returns
    once every node has committed every valid transfer (or fails at the
    deadline). The wall time runs from the first submission to the last
    commit on any node."""
    n = len(nodes)
    own = [[nodes[c % n].own(p) for p in mine] for c, mine in enumerate(subs)]
    for node in nodes:
        node.want = len(valid)

    async def client(c: int) -> None:
        node = nodes[c % n]
        for p in own[c]:
            await node.submit(p)
            await asyncio.sleep(0)

    t0 = time.perf_counter()
    await asyncio.gather(*(client(c) for c in range(len(subs))))
    try:
        await asyncio.wait_for(asyncio.gather(*(node.done.wait() for node in nodes)), deadline_s)
    except asyncio.TimeoutError:
        for node in nodes:  # a commit loop that died explains the stall
            for t in node._tasks:
                if t.done() and not t.cancelled() and t.exception() is not None:
                    raise t.exception()
        counts = [len(node.committed) for node in nodes]
        raise RuntimeError(f"chip_smoke: committed {counts} of {len(valid)} transfers "
                           f"per node within {deadline_s} s") from None
    wall = max(node.last_commit_t for node in nodes) - t0
    return {"wall_s": wall, "tx_per_s": len(valid) / wall}


async def check_ledgers(nodes: list, valid: list, good_hash: dict, bad_hashes: set) -> dict:
    """Checks 1 and 2 of the net: equal ledgers that equal the python-int
    replay of the valid transfers, and no tampered content committed."""
    states = [await node.accounts.export_state() for node in nodes]
    replay = replay_ledger(sorted(valid, key=lambda t: (t[0], t[1])))
    for i, (node, state) in enumerate(zip(nodes, states)):
        check(not node.consumed, f"node {i}: {len(node.consumed)} transfers failed their debit")
        check(state == states[0], f"node {i}'s ledger differs from node 0's")
        committed_bad = sum(1 for h in node.committed.values() if h in bad_hashes)
        check(committed_bad == 0, f"node {i} committed {committed_bad} tampered transfers")
        check(node.committed == good_hash, f"node {i} committed other contents than the valid ones")
    check(states[0] == replay, "the ledgers differ from the python-int replay of the valid transfers")
    return states[0]


async def broadcast_net(label: str, rng, batching: bool, per_client: int, by_lanes: dict,
                        deadline_s: float) -> dict:
    """One run of phase 5: four port nodes over encrypted TCP on
    127.0.0.1, each verifying through its own ``make_verifier("cuda")`` at
    the node's default [verifier] table; 16 clients; every valid transfer
    commits on all four ledgers."""
    from at2_node_tpu_torch.crypto.verifier import make_verifier
    from at2_node_tpu_torch.native import ingest
    from at2_node_tpu_torch.ops import cuda_verify

    m = port_modules()
    verifiers, logs = [], []
    for _ in range(NET_NODES):
        ver = make_verifier("cuda", batch_size=256, max_delay=0.002)
        await ver.warmup()
        ver.recorder = FlushLog()
        verifiers.append(ver)
        logs.append(ver.recorder)
    nodes = await start_net([m] * NET_NODES, verifiers, rng, batching=batching)
    try:
        subs, valid, good_hash, bad_hashes = make_traffic(
            m, rng, NET_CLIENTS, per_client, TAMPER_SHARE)
        tampered_at = Counter()
        for c, mine in enumerate(subs):
            tampered_at[c % NET_NODES] += sum(1 for p in mine if p.content_hash() in bad_hashes)
        for log_ in logs:
            log_.flushes.clear()
        sigs0 = [v.signatures_verified for v in verifiers]
        cuda_verify.launches = 0
        run = await drive_net(nodes, subs, valid, deadline_s)
        launches = cuda_verify.launches
        state = await check_ledgers(nodes, valid, good_hash, bad_hashes)

        per_node = []
        for i, (node, ver, log_) in enumerate(zip(nodes, verifiers, logs)):
            buckets = [ver._bucket_for(min(take, depth)) for take, depth, _ in log_.flushes]
            stats = ver.stats()
            check(ver.device.type == "cuda", f"node {i}'s verifier is on {ver.device}")
            check(stats["batches"] > 0, f"node {i}'s verifier dispatched no batch")
            check(set(buckets) == {256}, f"node {i} flushed buckets {sorted(set(buckets))}")
            invalid = node.bcast.stats["invalid_sig"]
            # a tampered batch entry reaches every node; a tampered
            # per-transaction payload only the node it was submitted to
            need = len(bad_hashes) if batching else tampered_at[i]
            check(invalid >= need, f"node {i} counted {invalid} invalid signatures, expected >= {need}")
            per_node.append({
                "signatures": ver.signatures_verified - sigs0[i], "flushes": len(buckets),
                "batches": stats["batches"], "batch_occupancy": stats["batch_occupancy"],
                "invalid_sig": invalid, "slots_sent": node.batches_sent,
                "native_readers": node.mesh.stats()["native_readers"],
                "stage_histograms": ver.stage_histograms(),
            })
        flushes = sum(p["flushes"] for p in per_node)
        check(launches > 0, f"{label}: ran without launching the kernel")
        check(launches == flushes, f"{label}: {flushes} flushes but {launches} launches")
        share = flushes * by_lanes[256]["ms"] / (1e3 * run["wall_s"])
        native = ingest.ingest_ready()
        log(f"{label}: {len(valid)} transfers ({len(bad_hashes)} tampered twins) from "
            f"{NET_CLIENTS} clients committed on all {NET_NODES} nodes in {run['wall_s']:.3f} s "
            f"= {run['tx_per_s']:,.0f} tx/s; {launches} kernel launches, kernel busy "
            f"{100 * share:.1f}% of the wall time (phase 3 times); {len(state)} accounts, ledgers "
            f"equal to each other and to the replay")
        log(f"{label}: native ingest library {'on' if native else 'OFF (python fallback)'}, "
            f"native readers {[p['native_readers'] for p in per_node]} per node; the four nodes "
            f"share one process and one GIL, so the rate is a floor for a 4-node net")
        for i, p in enumerate(per_node):
            log(f"{label} node {i}: {p['signatures']} signatures verified, {p['batches']} batches, "
                f"occupancy {p['batch_occupancy']:.3f}, invalid_sig {p['invalid_sig']}, "
                f"{p['slots_sent']} batch slots sent")
            log(f"{label} node {i} stage histograms:", json.dumps(p.pop("stage_histograms"), sort_keys=True))
        return {"launches": launches, "tx_per_s": run["tx_per_s"], "wall_s": run["wall_s"],
                "transfers": len(valid), "tampered": len(bad_hashes), "kernel_busy_share": share,
                "native_ingest": native, "nodes": per_node}
    finally:
        for node in nodes:
            await node.close()


async def net_path(seed: int, by_lanes: dict) -> dict:
    rng = np.random.default_rng(seed + 5)
    return {
        "net_batched": await broadcast_net(
            "net (batched plane)", rng, True, NET_PER_CLIENT_BATCHED, by_lanes, NET_DEADLINE_S),
        "net_per_tx": await broadcast_net(
            "net (per-transaction plane)", rng, False, NET_PER_CLIENT_PER_TX, by_lanes, NET_DEADLINE_S),
    }


# -- phase 6 ---------------------------------------------------------------


def server_argv(*args: str) -> list:
    return [sys.executable, "-m", "at2_node_tpu_torch.cli.server", *args]


def repo_root() -> str:
    return os.path.dirname(os.path.abspath(__file__))


def checkout_env() -> dict:
    """The environment of a process started from this checkout: the
    checkout first on PYTHONPATH."""
    env = dict(os.environ)
    env["PYTHONPATH"] = repo_root() + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return env


class ServerNet:
    """``n`` ``server run`` processes on 127.0.0.1, configured the way an
    operator does it: one ``server config new`` per node (``--verifier
    cpu`` for the host kind), every other node's ``config get-node``
    fragment appended. ``top``, when given, is top-level TOML keys put
    before node i's config (the thresholds); ``tables(i)`` is TOML text
    appended after the fragments (``[plane]``, ``[store]``); ``regions[j]``,
    when given, is the ``region`` hint added to node j's fragment."""

    def __init__(self, kind: str, workdir: str, n: int = NET_NODES, mode: str = "auto",
                 top: str = "", tables=None, regions=None) -> None:
        self.kind = kind
        self.mode = mode
        self.workdir = workdir
        self.n = n
        self.top = top
        self.tables = tables
        self.regions = regions
        self.procs: list = []
        self.logs: list = []
        self.tomls: list = []
        self.rpc_ports: list = []
        self.terminated: set = set()  # the server processes sent SIGTERM

    def cli(self, *args: str) -> list:
        """The argv of a ``server`` CLI command."""
        return server_argv(*args)

    def env(self) -> dict:
        """The environment of the CLI commands and the servers."""
        return checkout_env()

    def _spawn_cli(self, argvs: list) -> list:
        """CLI commands started side by side, their input still open."""
        return [subprocess.Popen(a, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True, env=self.env())
                for a in argvs]

    @staticmethod
    def _finish_cli(argvs: list, procs: list, inputs: list) -> list:
        """Each started command given its input and run to its end; their
        standard outputs."""
        outs = []
        for argv, proc, text in zip(argvs, procs, inputs):
            out, err = proc.communicate(text, timeout=120)
            check(proc.returncode == 0, f"{' '.join(argv[1:])} failed: {err.strip()[-2000:]}")
            outs.append(out)
        return outs

    def start(self, deadline_s: float, ports: list | None = None) -> None:
        """Configure, spawn and wait for the nodes; ``ports`` (2n of them),
        when given, in place of n fresh pairs (two nets started at once
        take theirs from one ``free_ports`` call, so they cannot draw the
        same port)."""
        ports = ports or free_ports(2 * self.n)
        node_ports, self.rpc_ports = ports[0::2], ports[1::2]
        # the card's kind is config new's default; the host's is asked for
        ask = [] if self.kind == "cuda" else ["--verifier", self.kind]
        new = [self.cli("config", "new", *ask, f"127.0.0.1:{a}", f"127.0.0.1:{b}")
               for a, b in zip(node_ports, self.rpc_ports)]
        get = [self.cli("config", "get-node")] * self.n
        # every `config get-node` starts beside the `config new`s and waits
        # on its input, so the interpreters start up together
        new_procs, get_procs = self._spawn_cli(new), self._spawn_cli(get)
        try:
            configs = self._finish_cli(new, new_procs, [""] * self.n)
            table = f'[verifier]\nkind = "{self.kind}"\nbatch_size = 256\nmax_delay = 0.002\nmode = "auto"\n'
            check(all(c.count(table) == 1 for c in configs),
                  f"config new wrote no node default [verifier] table of kind {self.kind!r}")
            # the operator's one edit for another verifier mode
            configs = [c.replace(table, table.replace('"auto"', f'"{self.mode}"')) for c in configs]
            fragments = self._finish_cli(get, get_procs, configs)
        finally:
            for proc in get_procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        if self.regions is not None:  # the operator's hint on each [[nodes]] entry
            fragments = [f.rstrip("\n") + f'\nregion = "{self.regions[j]}"\n' for j, f in enumerate(fragments)]
        for i in range(self.n):
            toml = self.top + configs[i] + "\n" + "\n".join(f for j, f in enumerate(fragments) if j != i)
            if self.tables is not None:
                toml += "\n" + self.tables(i)
            path = os.path.join(self.workdir, f"node{i}.toml")
            with open(path, "w") as f:
                f.write(toml)
            self.tomls.append(path)
            self.logs.append(os.path.join(self.workdir, f"node{i}.log"))
            self.procs.append(self._spawn(i, "w"))
        # a node binds its RPC port after its verifier's warmup
        t_end = time.perf_counter() + deadline_s
        for i in range(self.n):
            self.wait_rpc(i, t_end)
        while True:
            # a node that could not bind its port exits, and another
            # process's socket may answer there in its place
            for i, p in enumerate(self.procs):
                check(p.poll() is None, f"node {i} exited with {p.returncode}: {self.log_tail(i)}")
            try:
                if all(self.stats(i)["mesh_channels"] >= 2 * (self.n - 1) for i in range(self.n)):
                    break
            except (OSError, http.client.HTTPException):
                pass
            check(time.perf_counter() < t_end, f"the {self.n}-node mesh did not connect in {deadline_s} s")
            time.sleep(0.05)

    def _spawn(self, i: int, log_mode: str):
        with open(self.tomls[i]) as stdin, open(self.logs[i], log_mode) as out:
            return subprocess.Popen(server_argv("run"), stdin=stdin, stdout=out,
                                    stderr=subprocess.STDOUT, env=self.env())

    def wait_rpc(self, i: int, t_end: float) -> None:
        while not self._accepts(self.rpc_ports[i]):
            check(self.procs[i].poll() is None,
                  f"node {i} exited with {self.procs[i].returncode}: {self.log_tail(i)}")
            check(time.perf_counter() < t_end, f"node {i}'s RPC port never came up: {self.log_tail(i)}")
            time.sleep(0.05)

    def kill(self, i: int) -> None:
        """SIGKILL node i: no shutdown drain, no final store flush."""
        import signal

        self.procs[i].send_signal(signal.SIGKILL)
        self.procs[i].wait(timeout=60)

    def restart(self, i: int) -> None:
        """Start node i again from its TOML (its store directory with it)."""
        self.procs[i] = self._spawn(i, "a")

    @staticmethod
    def _accepts(port: int) -> bool:
        import socket

        try:
            with socket.create_connection(("127.0.0.1", port), timeout=1):
                return True
        except OSError:
            return False

    def log_tail(self, i: int, n: int = 3000) -> str:
        with open(self.logs[i]) as f:
            return f.read()[-n:]

    def get(self, i: int, path: str) -> str:
        import urllib.request

        with urllib.request.urlopen(f"http://127.0.0.1:{self.rpc_ports[i]}{path}", timeout=30) as r:
            return r.read().decode()

    def statusz(self, i: int) -> dict:
        return json.loads(self.get(i, "/statusz"))

    def stats(self, i: int) -> dict:
        return self.statusz(i)["stats"]

    def committed(self, i: int) -> int:
        """Transfers node ``i`` has committed, from /healthz: a small body
        (a 503 verdict carries it too)."""
        import urllib.error

        try:
            body = self.get(i, "/healthz")
        except urllib.error.HTTPError as exc:
            body = exc.read().decode()
        return json.loads(body)["committed"]

    def metrics(self, i: int) -> dict:
        """/metrics as {name: value} (the exposition's sample lines)."""
        out = {}
        for line in self.get(i, "/metrics").splitlines():
            if line and not line.startswith("#"):
                name, _, value = line.rpartition(" ")
                out[name] = float(value)
        return out

    def terminate(self) -> None:
        """SIGTERM every server that runs, once (a second SIGTERM would
        kill a server mid-shutdown), without waiting for it."""
        import signal

        for p in self.procs:
            if p.poll() is None and p not in self.terminated:
                p.send_signal(signal.SIGTERM)
                self.terminated.add(p)

    def stop(self) -> list:
        """SIGTERM every server; their exit codes."""
        self.terminate()
        rcs = []
        for p in self.procs:
            try:
                rcs.append(p.wait(timeout=60))
            except subprocess.TimeoutExpired:
                p.kill()
                rcs.append(p.wait())
        return rcs


def more_transfers(rng, clients: list, first_seq: int, per_client: int) -> list:
    """``per_client`` transfers a client, sequences ``first_seq``.., each to
    another client with an amount of 1-50 (no debit can fail)."""
    n = len(clients)
    return [[(seq, clients[(c + 1 + int(rng.integers(0, n - 1))) % n].public, int(rng.integers(1, 51)))
             for seq in range(first_seq, first_seq + per_client)] for c in range(n)]


def node_traffic(rng, n_clients: int, per_batched: int, per_unary: int, n_tampered: int):
    """Seeded wallets and their transfers, sequences 1..per_batched (run A)
    then per_batched+1..+per_unary (run B), each to another client with an
    amount of 1-50 (no debit can fail). ``n_tampered`` run-B slots, spread
    over the clients, get a tampered twin (another amount, one signature
    bit flipped) sent just before the valid transfer."""
    from at2_node_tpu_torch.crypto.keys import SignKeyPair
    from at2_node_tpu_torch.types import transfer_signing_bytes

    clients = [SignKeyPair(rng.bytes(32)) for _ in range(n_clients)]
    run_a = more_transfers(rng, clients, 1, per_batched)
    run_b = more_transfers(rng, clients, per_batched + 1, per_unary)
    twins: dict = {}
    for k in range(n_tampered):
        c = k % n_clients
        seq, recipient, amount = run_b[c][int(rng.integers(0, per_unary))]
        sig = bytearray(clients[c].sign(
            transfer_signing_bytes(clients[c].public, seq, recipient, amount + 1)))
        sig[int(rng.integers(0, 64))] ^= 1 << int(rng.integers(0, 8))
        twins[(c, seq)] = (recipient, amount + 1, bytes(sig))
    return clients, run_a, run_b, twins


def signing_pass(clients: list, per_client: list) -> float:
    """Seconds this process takes to sign every transfer once: the signing
    the Client does inside its calls, measured apart."""
    from at2_node_tpu_torch.types import transfer_signing_bytes

    t0 = time.perf_counter()
    for kp, transfers in zip(clients, per_client):
        for seq, recipient, amount in transfers:
            kp.sign(transfer_signing_bytes(kp.public, seq, recipient, amount))
    return time.perf_counter() - t0


def wait_committed(net: ServerNet, want: list, deadline_s: float, nodes=None) -> float:
    """Poll each node's committed count (one /healthz GET per node every
    NODE_POLL_S) until node i has committed ``want[i]``; the perf_counter
    time of the poll that saw the last node get there. The window's end
    is known to within one poll period, and the probe costs each node
    1/NODE_POLL_S small requests a second. ``nodes``: the nodes to wait
    for (every node by default)."""
    pending = set(range(net.n) if nodes is None else nodes)
    t_end = time.perf_counter() + deadline_s
    last = 0.0
    while pending:
        check(time.perf_counter() < t_end,
              f"nodes {sorted(pending)} short of {[want[i] for i in sorted(pending)]} commits "
              f"after {deadline_s} s")
        for i in sorted(pending):
            if net.committed(i) >= want[i]:
                pending.discard(i)
                last = time.perf_counter()
        if pending:
            time.sleep(NODE_POLL_S)
    return last


async def check_sequences(net: ServerNet, clients: list, want: int) -> None:
    """Once, after a run's window: every client's GetLastSequence on every
    node is ``want``."""
    from at2_node_tpu_torch.client import Client

    for i, port in enumerate(net.rpc_ports):
        async with Client(f"http://127.0.0.1:{port}") as conn:
            seqs = await asyncio.gather(*(conn.get_last_sequence(kp.public) for kp in clients))
        short = [c for c, s in enumerate(seqs) if s != want]
        check(not short, f"node {i}: clients {short} are not at sequence {want}")


async def check_replay(net: ServerNet, clients: list, per_client: list) -> None:
    """Every node's ledger (``GetLastSequence`` and ``GetBalance`` of every
    client) equals the python-int replay of ``per_client[c]``, client c's
    transfers."""
    from at2_node_tpu_torch.client import Client

    replay = replay_ledger([(clients[c].public, seq, r, a)
                            for c in range(len(clients)) for seq, r, a in per_client[c]])
    for i, port in enumerate(net.rpc_ports):
        async with Client(f"http://127.0.0.1:{port}") as conn:
            got = await asyncio.gather(*(asyncio.gather(conn.get_last_sequence(kp.public),
                                                        conn.get_balance(kp.public)) for kp in clients))
        for kp, (seq, bal) in zip(clients, got):
            check([seq, bal] == replay[kp.public.hex()],
                  f"node {i}: {kp.public.hex()[:12]} has sequence {seq}, balance {bal}; "
                  f"the replay says {replay[kp.public.hex()]}")


async def grpcweb_transfer(net: ServerNet, rng, kind: str, deadline_s: float) -> dict:
    """Phase 6, after run A: one grpc-web ``SendAsset`` from a fresh
    account to node 0's RPC port, as the browser wallet sends it (binary
    mode: one HTTP/1.1 POST, the request in one ``net/webmux._frame``). It
    must answer grpc-status 0 with CORS allow-all and commit on every node
    (the recipient's balance read back through each), and on the card
    node 0's verify kernel must have launched for it."""
    from at2_node_tpu_torch.client import Client
    from at2_node_tpu_torch.crypto.keys import SignKeyPair
    from at2_node_tpu_torch.ledger.account import INITIAL_BALANCE
    from at2_node_tpu_torch.net.webmux import _DATA_FRAME, _TRAILER_FRAME, _frame, _parse_frames
    from at2_node_tpu_torch.proto import at2_pb2 as pb
    from at2_node_tpu_torch.types import transfer_signing_bytes

    sender, recipient = SignKeyPair(rng.bytes(32)), SignKeyPair(rng.bytes(32))
    amount = 77
    request = pb.SendAssetRequest(
        sender=sender.public, sequence=1, recipient=recipient.public, amount=amount,
        signature=sender.sign(transfer_signing_bytes(sender.public, 1, recipient.public, amount)))
    body = _frame(request.SerializeToString())
    before = [net.statusz(i) for i in range(net.n)]
    t0 = time.perf_counter()
    reader, writer = await asyncio.open_connection("127.0.0.1", net.rpc_ports[0])
    writer.write((f"POST /at2.AT2/SendAsset HTTP/1.1\r\nHost: node\r\n"
                  f"Content-Type: application/grpc-web+proto\r\nX-Grpc-Web: 1\r\n"
                  f"Content-Length: {len(body)}\r\nConnection: close\r\n\r\n").encode() + body)
    await writer.drain()
    raw = await asyncio.wait_for(reader.read(-1), deadline_s)
    writer.close()
    head, _, payload = raw.partition(b"\r\n\r\n")
    lines = head.decode("latin-1").split("\r\n")
    headers = {k.strip().lower(): v.strip() for k, _, v in (h.partition(":") for h in lines[1:])}
    check(" 200 " in lines[0] + " ", f"grpc-web SendAsset: {lines[0]}")
    check(headers.get("access-control-allow-origin") == "*", f"grpc-web SendAsset: headers {headers}")
    frames = _parse_frames(payload)
    trailers = [d.decode() for f, d in frames if f == _TRAILER_FRAME]
    check([f for f, _ in frames].count(_DATA_FRAME) == 1 and any(
        line.lower().replace(" ", "") == "grpc-status:0" for t in trailers for line in t.split("\r\n")),
        f"grpc-web SendAsset: frames {frames}")
    reply_s = time.perf_counter() - t0
    wait_committed(net, [b["stats"]["committed"] + 1 for b in before], deadline_s)
    commit_s = time.perf_counter() - t0
    for i, port in enumerate(net.rpc_ports):
        async with Client(f"http://127.0.0.1:{port}") as conn:
            bal = await conn.get_balance(recipient.public)
            seq = await conn.get_last_sequence(sender.public)
        check((bal, seq) == (INITIAL_BALANCE + amount, 1),
              f"grpc-web SendAsset: node {i} has the recipient at {bal}, the sender at sequence {seq}")
    launches = net.statusz(0)["build"]["kernel_launches"] - before[0]["build"]["kernel_launches"]
    check(kind != "cuda" or launches > 0, "grpc-web SendAsset: node 0 launched no verify kernel")
    log(f"node net (grpc-web SendAsset): one transfer from a fresh account, binary mode, to node 0: "
        f"grpc-status 0 in {reply_s:.3f} s, committed on all {net.n} nodes in {commit_s:.3f} s (the "
        f"recipient's balance {INITIAL_BALANCE + amount} read back from each); node 0's verify kernel "
        f"launches grew by {launches}")
    return {"reply_s": reply_s, "commit_s": commit_s, "launches": launches}


async def node_run(net: ServerNet, label: str, clients: list, transfers: list, batched: bool,
                   twins: dict, want_seq: int, deadline_s: float) -> dict:
    """One phase-6 run: client c submits its transfers, in order, to node c
    mod n through the port's Client (``send_asset_many`` or ``send_asset``),
    each tampered twin first through a raw stub; returns once every node
    has committed every valid transfer."""
    import grpc

    from at2_node_tpu_torch.client import Client
    from at2_node_tpu_torch.proto import at2_pb2 as pb
    from at2_node_tpu_torch.proto.rpc import At2Stub

    n = net.n
    sign_s = signing_pass(clients, transfers)
    n_sigs = sum(len(t) for t in transfers)
    refused = Counter()

    async def client(c: int) -> None:
        url = f"127.0.0.1:{net.rpc_ports[c % n]}"
        kp = clients[c]
        async with Client(f"http://{url}") as conn:
            if batched:
                await conn.send_asset_many(kp, transfers[c])
                return
            channel = grpc.aio.insecure_channel(url)
            stub = At2Stub(channel)
            try:
                for seq, recipient, amount in transfers[c]:
                    twin = twins.get((c, seq))
                    if twin is not None:
                        req = pb.SendAssetRequest(sender=kp.public, sequence=seq, recipient=twin[0],
                                                  amount=twin[1], signature=twin[2])
                        try:
                            await stub.SendAsset(req)
                        except grpc.aio.AioRpcError as exc:
                            check(exc.code() == grpc.StatusCode.INVALID_ARGUMENT,
                                  f"a tampered transfer got {exc.code()}, not INVALID_ARGUMENT")
                            refused[c % n] += 1
                        else:
                            check(False, "a tampered transfer was admitted")
                    await conn.send_asset(kp, seq, recipient, amount)
            finally:
                await channel.close()

    before = [net.statusz(i) for i in range(n)]
    t0 = time.perf_counter()
    await asyncio.gather(*(client(c) for c in range(len(clients))))
    submit_s = time.perf_counter() - t0
    t_last = wait_committed(net, [b["stats"]["committed"] + n_sigs for b in before], deadline_s)
    wall = t_last - t0
    await check_sequences(net, clients, want_seq)
    return {"label": label, "wall_s": wall, "tx_per_s": n_sigs / wall, "transfers": n_sigs,
            "clients": len(clients), "t_last": t_last,
            "sign_s": sign_s, "submit_s": submit_s, "refused": refused, "before": before}


async def node_path(seed: int, by_lanes, card, kind: str = "cuda", n_clients: int = NET_CLIENTS,
                    per_batched: int = NET_PER_CLIENT_BATCHED, per_unary: int = NET_PER_CLIENT_PER_TX,
                    n_tampered: int = NODE_TAMPERED, deadline_s: float = NET_DEADLINE_S,
                    mode: str = "auto", net: ServerNet | None = None) -> dict:
    """Phase 6 (and, with ``mode="rlc"``, phase 7): four ``server run``
    processes with ``[verifier] kind`` and ``mode``; run A through
    ``send_asset_many``, run B through unary ``send_asset`` with tampered
    twins; then the ledgers, refusals, metrics and shutdown are checked.
    ``by_lanes`` (phase 3's and 3b's kernel times by kernel name) and
    ``card`` (the name the build block must carry) are None off the card.
    ``net``: such a net already started (``start_pair``), else one is
    started here; either way it is stopped here."""
    import contextlib
    import tempfile

    rng = np.random.default_rng(seed + (6 if mode == "auto" else 7))
    clients, run_a, run_b, twins = node_traffic(rng, n_clients, per_batched, per_unary, n_tampered)
    prefix = "" if mode == "auto" else f"{mode} "
    with contextlib.ExitStack() as stack:
        t0 = time.perf_counter()
        try:
            if net is None:
                net = ServerNet(kind, stack.enter_context(tempfile.TemporaryDirectory(prefix="at2-phase6-")),
                                mode=mode)
                net.start(deadline_s=180.0)
            log(f"{prefix}node net: {net.n} `server run` processes, [verifier] kind = \"{kind}\", "
                f"mode = \"{mode}\", up and meshed {time.perf_counter() - t0:.1f} s after this phase began")
            runs = {}
            refused_total = Counter()
            for name, label, transfers, batched, want in (
                ("node_grpc_batched", "node net (SendAssetBatch)", run_a, True, per_batched),
                ("node_grpc_unary", "node net (unary SendAsset)", run_b, False, per_batched + per_unary),
            ):
                run = await node_run(net, prefix + label, clients, transfers, batched,
                                     {} if batched else twins, want, deadline_s)
                refused_total.update(run["refused"])
                runs[prefix.replace(" ", "_") + name] = node_checks(
                    net, run, by_lanes, card, kind, refused_total, mode)
                if batched and mode == "auto":
                    runs["node_grpc_web"] = await grpcweb_transfer(net, rng, kind, deadline_s)
            check(sum(refused_total.values()) == len(twins),
                  f"{sum(refused_total.values())} of {len(twins)} tampered transfers refused")
            # the ledgers: every valid transfer committed on every node
            await check_replay(net, clients, [run_a[c] + run_b[c] for c in range(n_clients)])
            log(f"{prefix}node net: {len(clients)} accounts equal the python-int replay on all {net.n} "
                f"nodes; {sum(refused_total.values())} tampered transfers refused with INVALID_ARGUMENT")
        finally:
            rcs = net.stop()
        check(rcs == [0] * net.n, f"servers exited with {rcs} on SIGTERM")
        log(f"{prefix}node net: every server exited 0 on SIGTERM")
    return runs


def _lanes(st: dict) -> float:
    """Kernel lanes a verifier has launched since its node started
    (signatures plus padding), from its cumulative occupancy."""
    occ = st.get("verifier_batch_occupancy", 0.0)
    return st["verifier_signatures"] / occ if occ else 0.0


def node_checks(net: ServerNet, run: dict, by_lanes, card, kind: str, refused: Counter,
                mode: str = "auto") -> dict:
    """After a run: each node's /metrics (audit_divergence 0,
    rejected_at_ingress equal to the tampered transfers refused there so
    far), verifier counters, the kernels' launch counts and the card in its
    /statusz build block. In mode "rlc" every batch goes through the RLC
    kernels, and the verify kernel runs once a fallback."""
    label = run["label"]
    per_node, launches, rlc_launches = [], 0, 0
    for i in range(net.n):
        status, status0 = net.statusz(i), run["before"][i]
        st, st0 = status["stats"], status0["stats"]
        m = net.metrics(i)
        check(m["at2_audit_divergence"] == 0, f"node {i}: audit_divergence {m['at2_audit_divergence']}")
        check(m["at2_rejected_at_ingress_total"] == refused[i],
              f"node {i}: rejected_at_ingress {m['at2_rejected_at_ingress_total']}, {refused[i]} refused")
        sigs = st["verifier_signatures"] - st0["verifier_signatures"]
        check(sigs > 0, f"{label} node {i}: the verifier checked no signature")
        # the CPU kind (a rehearsal off the card) has no batches
        batches = st.get("verifier_batches", 0) - st0.get("verifier_batches", 0)
        node_launches = node_rlc = fallbacks = 0
        if kind == "cuda":
            check(batches > 0, f"{label} node {i}: the verifier dispatched no batch")
            check(status["build"].get("device") == card,
                  f"node {i}'s build block names {status['build'].get('device')!r}, not {card!r}")
            # the process-wide counts: a `server run` process holds one verifier
            b, b0 = status["build"], status0["build"]
            node_launches = b["kernel_launches"] - b0["kernel_launches"]
            node_rlc = b["rlc_kernel_launches"] - b0["rlc_kernel_launches"]
            node_fold = b["rlc_fold_launches"] - b0["rlc_fold_launches"]
            rlc_batches = st["verifier_rlc_batches"] - st0["verifier_rlc_batches"]
            fallbacks = st["verifier_rlc_fallbacks"] - st0["verifier_rlc_fallbacks"]
            if mode == "rlc":
                check(rlc_batches == batches, f"{label} node {i}: {batches} batches, {rlc_batches} RLC")
                check(node_rlc == node_fold == rlc_batches,
                      f"{label} node {i}: {rlc_batches} RLC batches, RLC kernel launches "
                      f"{node_rlc} and {node_fold}")
                check(node_launches == fallbacks,
                      f"{label} node {i}: {fallbacks} fallbacks, {node_launches} verify kernel launches")
                check(fallbacks >= 1 or not run["refused"][i],
                      f"{label} node {i} refused a twin without an exact pass")
            else:
                check(node_launches == batches, f"{label} node {i}: {batches} batches, {node_launches} launches")
                check(node_rlc == node_fold == rlc_batches == 0, f"{label} node {i}: RLC ran in mode {mode}")
        launches += node_launches
        rlc_launches += node_rlc
        per_node.append({
            "signatures": sigs, "batches": batches, "launches": node_launches,
            # this run's: signatures over the lanes its batches launched
            "batch_occupancy": sigs / (_lanes(st) - _lanes(st0)) if batches else 0.0,
            "rejected_at_ingress": int(m["at2_rejected_at_ingress_total"]),
            "rlc_launches": node_rlc, "rlc_fallbacks": fallbacks,
            "kernel_busy_share": ((node_launches * by_lanes["ed25519_verify"][256]["ms"]
                                   + node_rlc * (by_lanes["ed25519_rlc_lanes"][256]["ms"]
                                                 + by_lanes["ed25519_rlc_fold"][256]["ms"]))
                                  / (1e3 * run["wall_s"]) if by_lanes else None),
            "stage_histograms": status["verifier_stages"],
        })
    if kind == "cuda":
        check((rlc_launches if mode == "rlc" else launches) > 0, f"{label}: ran without launching a kernel")
    log(f"{label}: {run['transfers']} transfers from {run['clients']} clients "
        f"committed on all {net.n} nodes in {run['wall_s']:.3f} s = {run['tx_per_s']:,.0f} tx/s "
        f"(first submission to last commit); client signing {run['sign_s']:.3f} s measured apart, "
        f"submission {run['submit_s']:.3f} s; {launches} verify kernel launches, {rlc_launches} RLC "
        f"kernel launches")
    for i, p in enumerate(per_node):
        busy = p["kernel_busy_share"]
        log(f"{label} node {i}: {p['signatures']} signatures verified, {p['batches']} batches, "
            f"{p['rlc_launches']} through RLC, {p['rlc_fallbacks']} fallbacks, "
            f"occupancy {p['batch_occupancy']:.3f}, rejected_at_ingress {p['rejected_at_ingress']}"
            + (f", kernel busy {100 * busy:.1f}% of the wall time (phase 3 times)" if busy is not None else ""))
        log(f"{label} node {i} stage histograms since the node started:",
            json.dumps(p.pop("stage_histograms"), sort_keys=True))
    return {"launches": launches, "rlc_launches": rlc_launches, "tx_per_s": run["tx_per_s"],
            "wall_s": run["wall_s"], "transfers": run["transfers"], "sign_s": run["sign_s"],
            "submit_s": run["submit_s"], "nodes": per_node}


# -- phase 9 ---------------------------------------------------------------


PLANE_SHARDS = 2
STORE_FLUSH_S = 1.0
RESTART_PER_CLIENT = NET_PER_CLIENT_BATCHED // 4  # 9c: a quarter of run A's traffic
# 9a/9b: a quarter of phase 6's run A a client, the cut that pays for
# phase 13 (phase 6 runs the same ingress at the full count)
PLANE_PER_CLIENT = NET_PER_CLIENT_BATCHED // 4
RESTART_WAL_PER_CLIENT = 8  # 9c: transfers a client node 0 holds in its WAL alone
RING_SLOTS = 4096  # the reference's [plane] defaults: 4,096 slots of 1 KiB
RING_SLOT_BYTES = 1024
RINGS_PER_SHARD = 3  # actions, effects, obs (parallel/plane.py)


def check_shm_room(n_nodes: int) -> None:
    """Prints ``df -B1 /dev/shm`` and fails unless the rings of ``n_nodes``
    nodes and of one node more (a killed node's, until they are removed)
    fit in its free space."""
    df = subprocess.run(["df", "-B1", "/dev/shm"], capture_output=True, text=True, timeout=30)
    log("df -B1 /dev/shm:", " | ".join(df.stdout.strip().splitlines()))
    st = os.statvfs("/dev/shm")
    free = st.f_bavail * st.f_frsize
    need = (n_nodes + 1) * PLANE_SHARDS * RINGS_PER_SHARD * RING_SLOTS * RING_SLOT_BYTES
    check(need <= free, f"/dev/shm has {free} bytes free, the plane's rings need {need}")


def rings_of(pids) -> list:
    """The plane rings in /dev/shm that the owners ``pids`` created."""
    return sorted(f for f in os.listdir("/dev/shm")
                  if any(f.startswith(f"at2pl-{pid}-") for pid in pids))


def _proc_read(pid: int, name: str) -> str:
    try:
        with open(f"/proc/{pid}/{name}", "rb") as f:
            return f.read().decode(errors="replace")
    except OSError:
        return ""


def proc_alive(pid: int) -> bool:
    """Whether ``pid`` runs (a zombie does not)."""
    stat = _proc_read(pid, "stat")
    return bool(stat) and stat.rsplit(")", 1)[1].split()[0] not in ("Z", "X")


def shard_workers(pid: int) -> list:
    """The spawn children of process ``pid`` (its plane shard workers),
    found by their parent pid in /proc."""
    out = []
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        stat = _proc_read(int(name), "stat")
        if stat and int(stat.rsplit(")", 1)[1].split()[1]) == pid and proc_alive(int(name)) \
                and "spawn_main" in _proc_read(int(name), "cmdline"):
            out.append(int(name))
    return sorted(out)


def maps_lib(pid: int, stem: str) -> bool:
    """Whether process ``pid`` has a file whose name holds ``stem`` mapped."""
    return any(stem in line.rsplit("/", 1)[-1] for line in _proc_read(pid, "maps").splitlines()
               if "/" in line)


def check_workers(net: ServerNet, label: str) -> dict:
    """Process executor: each server has its shard workers; none of them
    has mapped libcuda or libtorch (the servers have libcuda), and
    ``nvidia-smi --query-compute-apps`` lists no worker."""
    servers = [p.pid for p in net.procs]
    workers = {pid: shard_workers(pid) for pid in servers}
    for i, pid in enumerate(servers):
        check(len(workers[pid]) == PLANE_SHARDS,
              f"{label} node {i} (pid {pid}) has shard workers {workers[pid]}, not {PLANE_SHARDS}")
        check(net.kind != "cuda" or maps_lib(pid, "libcuda"), f"{label} node {i} has no libcuda mapped")
    every = [w for ws in workers.values() for w in ws]
    for w in every:
        check(not maps_lib(w, "libcuda"), f"{label}: shard worker {w} has libcuda mapped")
        check(not maps_lib(w, "libtorch"), f"{label}: shard worker {w} has libtorch mapped")
    if net.kind != "cuda":
        return {"servers": servers, "workers": every, "gpu_pids": None}
    smi = subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi --query-compute-apps failed: {smi.stderr.strip()}")
    gpu = sorted(int(x) for x in smi.stdout.split() if x.strip().isdigit())
    check(not set(gpu) & set(every), f"{label}: nvidia-smi lists shard workers: {gpu}, workers {every}")
    # the compute apps: the servers and this process; a worker with a
    # context would add one (in a container the pids may be of another
    # namespace, so they are counted too)
    check(len(gpu) <= len(servers) + 1,
          f"{label}: nvidia-smi lists {len(gpu)} compute apps ({gpu}) for {len(servers)} servers and this process")
    same_ns = bool(set(gpu) & set(servers))
    if same_ns:
        check(set(gpu) <= set(servers) | {os.getpid()},
              f"{label}: nvidia-smi lists {gpu}, the servers are {servers}")
    log(f"{label}: servers {servers}, shard workers {every} (none maps libcuda or libtorch; "
        f"every server maps libcuda); nvidia-smi lists {len(gpu)} compute apps {gpu}: at most the "
        f"{len(servers)} servers and this process"
        + ("" if same_ns else " (pids of another namespace)"))
    return {"servers": servers, "workers": every, "gpu_pids": gpu}


def send_batched(net: ServerNet, clients: list, per_client: list, node_of) -> "asyncio.Future":
    """Client c sends ``per_client[c]`` with ``send_asset_many`` to node
    ``node_of(c)``."""
    from at2_node_tpu_torch.client import Client

    async def one(c: int) -> None:
        async with Client(f"http://127.0.0.1:{net.rpc_ports[node_of(c)]}") as conn:
            await conn.send_asset_many(clients[c], per_client[c])

    return asyncio.gather(*(one(c) for c in range(len(clients))))


async def wait_sequences(net: ServerNet, i: int, clients: list, want: int, deadline_s: float) -> float:
    """Poll node i's GetLastSequence of every client until all are ``want``;
    the seconds it took."""
    from at2_node_tpu_torch.client import Client

    t0 = time.perf_counter()
    async with Client(f"http://127.0.0.1:{net.rpc_ports[i]}") as conn:
        while True:
            seqs = await asyncio.gather(*(conn.get_last_sequence(kp.public) for kp in clients))
            if all(s == want for s in seqs):
                return time.perf_counter() - t0
            check(time.perf_counter() - t0 < deadline_s,
                  f"node {i}: {sum(s != want for s in seqs)} clients short of sequence {want} "
                  f"after {deadline_s} s")
            await asyncio.sleep(0.1)


def store_line(net: ServerNet, label: str, history: int) -> list:
    """Each node's store counters and plane block, logged: the store must
    hold ``history`` committed bodies and have written segments (waiting
    up to three flush intervals for its next flush), and the plane's
    handoff drops must be 0."""
    out = []
    for i in range(net.n):
        t_end = time.perf_counter() + 3 * STORE_FLUSH_S
        while True:
            status = net.statusz(i)
            st = status["stats"]
            if st["store_segments_written"] > 0 or time.perf_counter() > t_end:
                break
            time.sleep(0.1)
        plane = status["plane"]
        dropped = net.metrics(i)["at2_plane_shard_effects_dropped"]
        check(dropped == 0, f"{label} node {i}: plane_shard_effects_dropped {dropped}")
        check(plane.get("shards") == PLANE_SHARDS and "worker_crashed" not in plane,
              f"{label} node {i}: plane block {plane}")
        row = {"store_flushes": st["store_flushes"], "store_segments_written": st["store_segments_written"],
               "store_segment_bytes": st["store_segment_bytes"], "store_gen": st["store_gen"],
               "store_history": st["store_history"], "plane": plane}
        check(row["store_segments_written"] > 0, f"{label} node {i}: the store wrote no segment")
        check(row["store_history"] == history,
              f"{label} node {i}: the store holds {row['store_history']} committed bodies, not {history}")
        log(f"{label} node {i}: store {row['store_flushes']} flushes, {row['store_segments_written']} "
            f"segments, {row['store_segment_bytes']} segment bytes, generation {row['store_gen']}, "
            f"{row['store_history']} committed bodies; plane {json.dumps(plane, sort_keys=True)}")
        out.append(row)
    return out


def launches_since(net: ServerNet, i: int, status0: dict, label: str) -> dict:
    """Node i's verify kernel launches and verifier batches since its
    ``/statusz`` snapshot ``status0`` (taken after its warm-up): a launch
    a batch, and at least one (the CPU kind has no batches)."""
    status = net.statusz(i)
    batches = status["stats"].get("verifier_batches", 0) - status0["stats"].get("verifier_batches", 0)
    if net.kind != "cuda":
        return {"batches": batches, "launches": 0}
    launches = status["build"]["kernel_launches"] - status0["build"]["kernel_launches"]
    check(batches > 0, f"{label} node {i}: the verifier dispatched no batch")
    check(launches == batches, f"{label} node {i}: {batches} batches, {launches} verify kernel launches")
    return {"batches": batches, "launches": launches}


def wal_records(store_dir: str) -> int:
    """The records in the WAL that the store's manifest names (read once
    its node is dead: the files are what a restart replays)."""
    from at2_node_tpu_torch.store.manifest import read_manifest
    from at2_node_tpu_torch.store.wal import replay

    doc = read_manifest(store_dir)
    check(doc is not None, f"no store manifest in {store_dir}")
    return sum(1 for _ in replay(os.path.join(store_dir, doc["wal"])))


STALL_KEYS = ("committed", "pending", "slots_undelivered", "inbox_depth", "delivered", "batch_rx",
              "batch_entries_delivered", "retransmits", "slots_dropped", "slots_retired",
              "poison_resolved", "entry_evictions", "invalid_sig")


async def stall_report(net: ServerNet, clients: list, want: int, label: str, store_dirs=None) -> None:
    """What a run that stopped short leaves to read, logged before it
    fails: each node's plane block and broadcast counters, its commit
    heap, the batch slots its plane still holds part-delivered
    (``/debugz`` ``plane_slots``), the clients it holds short of
    sequence ``want`` and the watermarks its store last flushed."""
    from at2_node_tpu_torch.client import Client
    from at2_node_tpu_torch.store.manifest import read_manifest

    for i in range(net.n):
        try:
            status = net.statusz(i)
            slots = json.loads(net.get(i, "/debugz")).get("plane_slots")
            async with Client(f"http://127.0.0.1:{net.rpc_ports[i]}") as conn:
                seqs = await asyncio.gather(*(conn.get_last_sequence(kp.public) for kp in clients))
        except Exception as exc:  # a dead node: report what the others hold
            log(f"{label} stall, node {i}: unreachable ({exc!r})")
            continue
        st = status["stats"]
        log(f"{label} stall, node {i}: plane {json.dumps(status.get('plane'), sort_keys=True)}; "
            + ", ".join(f"{k} {st.get(k)}" for k in STALL_KEYS))
        log(f"{label} stall, node {i}: clients short of sequence {want} (client: sequence) "
            f"{ {c: s for c, s in enumerate(seqs) if s != want} }")
        log(f"{label} stall, node {i}: part-delivered batch slots {json.dumps(slots, sort_keys=True)}")
        if store_dirs is not None:
            doc = read_manifest(store_dirs[i])
            log(f"{label} stall, node {i}: store watermarks (last flush) "
                f"{json.dumps(doc.get('watermarks') if doc else None, sort_keys=True)}")


async def restart_run(net: ServerNet, clients: list, rng, first_seq: int, per_client: int,
                      store0: str, card_line: str) -> dict:
    """9c: a quarter of run A's traffic. Its first half, but for the last
    RESTART_WAL_PER_CLIENT transfers a client, goes to every node and is
    flushed into node 0's segments; those last transfers go to nodes 1-3
    and node 0 is killed (SIGKILL) before its next flush (a small part,
    so that it commits within the flush interval), so what it committed
    of them lies in its WAL alone. The second
    half goes to nodes 1-3, node 0 restarts from its TOML and store
    directory (``store0``) and must replay its WAL whole, a last transfer
    a client goes to every node, and node 0 must reach every client's
    last sequence and the replay's ledger. Each node's verify kernel
    launches are counted from a snapshot after its warm-up: nodes 1-3
    from the start, node 0 from its restart's ``live``."""
    half = per_client // 2
    first = more_transfers(rng, clients, first_seq, half)
    second = more_transfers(rng, clients, first_seq + half, per_client - half)
    nudge = more_transfers(rng, clients, first_seq + per_client, 1)
    n = net.n
    label = "plane+store node net (9c, kill and restart)"
    to_peers = lambda c: c % n if c % n else 1 + c % (n - 1)  # noqa: E731
    status0 = [net.statusz(i) for i in range(n)]
    cut = half - min(half // 2, RESTART_WAL_PER_CLIENT)
    part1, part2 = [t[:cut] for t in first], [t[cut:] for t in first]
    before = [net.committed(i) for i in range(n)]
    seg0 = status0[0]["stats"]["store_segments_written"]
    await send_batched(net, clients, part1, lambda c: c % n)
    wait_committed(net, [b + sum(map(len, part1)) for b in before], NET_DEADLINE_S)
    # a flush of node 0's store that began after the first part had
    # committed: it folds its WAL into segments, and the next one begins a
    # flush interval after it ended, so after the last poll that did not
    # see it plus an interval
    t_quiet = t_wait = time.perf_counter()
    flushes = net.stats(0)["store_flushes"]
    while True:
        t_poll = time.perf_counter()
        st = net.stats(0)
        if st["store_flushes"] > flushes:
            break
        t_quiet = t_poll
        check(t_poll - t_wait < 5 * STORE_FLUSH_S, "node 0's store did not flush")
        time.sleep(0.02)
    check(st["store_segments_written"] > seg0, "node 0's store wrote no segment for the first part")
    flush_at = t_quiet + STORE_FLUSH_S  # node 0's next flush begins no sooner
    kill_by = flush_at - 0.1
    mid = [net.committed(i) for i in range(n)]
    await send_batched(net, clients, part2, to_peers)
    check(time.perf_counter() < kill_by,
          "the second part took longer to submit than node 0's store takes between flushes")
    want0 = mid[0] + sum(map(len, part2))
    while net.committed(0) < want0 and time.perf_counter() < kill_by:
        time.sleep(0.01)
    at_kill = net.committed(0) - mid[0]
    victim = net.procs[0].pid
    orphans = shard_workers(victim)
    t_kill = time.perf_counter()
    net.kill(0)
    check(t_kill < flush_at, f"node 0 was killed {t_kill - flush_at:.3f} s after its next flush could begin")
    wal_left = wal_records(store0)
    check(wal_left > 0, f"node 0 died with {at_kill} transfers of the second part committed and an "
                        f"empty WAL")
    # the orphaned shard workers see their owner gone and exit; then the
    # resource tracker they shared with it unlinks its rings
    while any(proc_alive(w) for w in orphans):
        check(time.perf_counter() - t_kill < 30, f"node 0's shard workers {orphans} outlived it")
        time.sleep(0.05)
    t_gone = time.perf_counter()
    while rings_of([victim]) and time.perf_counter() - t_gone < 10:
        time.sleep(0.05)
    stale = rings_of([victim])
    check(not stale, f"node 0's rings {stale} were left in /dev/shm 10 s after its workers exited")
    log(f"{label}: node 0 (pid {victim}) killed with SIGKILL {flush_at - t_kill:.3f} s before "
        f"its store's next flush could begin, with {at_kill} of the second part's "
        f"{sum(map(len, part2))} transfers committed and {wal_left} records in its WAL; its shard "
        f"workers {orphans} exited and its rings were gone from /dev/shm "
        f"{time.perf_counter() - t_kill:.3f} s after the kill")
    t_down = time.perf_counter()
    await send_batched(net, clients, second, to_peers)
    want = [None] + [mid[i] + (per_client - cut) * len(clients) for i in range(1, n)]
    pending = set(range(1, n))
    while pending:
        check(time.perf_counter() - t_down < NET_DEADLINE_S, f"nodes {sorted(pending)} stalled with node 0 down")
        pending = {i for i in pending if net.committed(i) < want[i]}
        time.sleep(NODE_POLL_S)
    down_s = time.perf_counter() - t_down
    # restart: the store is read before the RPC port binds, so the first
    # two recovery states are over by the time /statusz answers; its
    # recovery block counts them
    t_restart = time.perf_counter()
    net.restart(0)
    net.wait_rpc(0, t_restart + 180.0)
    rpc_s = time.perf_counter() - t_restart
    states = []
    while True:
        status = net.statusz(0)
        rec = status["recovery"]
        if not states or states[-1] != rec["state"]:
            states.append(rec["state"])
        if rec["state"] == "live":
            break
        check(time.perf_counter() - t_restart < 120, f"node 0 not live after 120 s: {rec}")
        time.sleep(0.05)
    live_s = time.perf_counter() - t_restart
    status0[0] = status
    order = ("cold", "loading_segments", "replaying_wal", "catchup", "live")
    check([order.index(x) for x in states] == sorted(order.index(x) for x in states),
          f"node 0's recovery states went {states}")
    check(rec["segments_loaded"] > 0, f"node 0 restarted without loading a segment: {rec}")
    check(rec["wal_records_replayed"] == wal_left,
          f"node 0 replayed {rec['wal_records_replayed']} WAL records, its WAL held {wal_left}")
    await send_batched(net, clients, nudge, lambda c: c % n)
    final_seq = first_seq + per_client
    catch_s = await wait_sequences(net, 0, clients, final_seq, NET_DEADLINE_S)
    for i in range(1, n):
        await wait_sequences(net, i, clients, final_seq, NET_DEADLINE_S)
    k1 = [launches_since(net, i, status0[i], label) for i in range(n)]
    log(f"{label}: node 0 restarted: RPC up {rpc_s:.3f} s after start, recovery states polled "
        f"{' -> '.join(states)}, live {live_s:.3f} s after start; recovery block "
        f"{json.dumps(rec, sort_keys=True)}; every client at sequence {final_seq} on node 0 "
        f"{catch_s:.3f} s after the last transfers; nodes 1-3 committed the second half in "
        f"{down_s:.3f} s with node 0 down; verify kernel launches a node {[k['launches'] for k in k1]} "
        f"(a launch a batch; node 0 since its restart went live, nodes 1-3 since the run began); "
        f"{card_line}")
    return {"transfers": len(clients) * (per_client + 1), "killed_at_part2": at_kill,
            "wal_records_at_kill": wal_left, "rpc_up_s": rpc_s, "live_s": live_s, "states": states,
            "recovery": rec, "catchup_s": catch_s, "down_commit_s": down_s, "nodes": k1,
            "per_client": [first[c] + second[c] + nudge[c] for c in range(len(clients))]}


async def plane_store_path(seed: int, by_lanes, card, card_line: str, kind: str = "cuda",
                           n_clients: int = NET_CLIENTS, per_batched: int = PLANE_PER_CLIENT,
                           restart_per_client: int = RESTART_PER_CLIENT) -> dict:
    """Phase 9: phase 6's net and run A's clients (same seed) with
    ``[plane] shards = 2`` and ``[store] dir``: 9a the thread executor,
    9b the process executor, 9c 9b's config at thresholds of two peers,
    a kill and a restart."""
    import contextlib
    import tempfile

    rng = np.random.default_rng(seed + 6)  # phase 6's: the same clients
    clients, run_a, _, _ = node_traffic(rng, n_clients, per_batched, NET_PER_CLIENT_PER_TX,
                                        NODE_TAMPERED)
    # 9a and 9b keep phase 6's thresholds (all three peers); 9c runs a
    # crash-fault net (f = 1: two peers), which keeps committing while a
    # node is down
    subs = (("9a", "thread", ""), ("9b", "process", ""),
            ("9c", "process", "echo_threshold = 2\nready_threshold = 2\n"))
    check_shm_room(NET_NODES)
    out = {}
    with contextlib.ExitStack() as stack:
        nets = []
        for sub, executor, top in subs:
            workdir = stack.enter_context(tempfile.TemporaryDirectory(prefix=f"at2-phase{sub}-"))

            def tables(i: int, executor=executor, workdir=workdir) -> str:
                return (f'[plane]\nshards = {PLANE_SHARDS}\nexecutor = "{executor}"\n'
                        f"ring_slots = {RING_SLOTS}\nring_slot_bytes = {RING_SLOT_BYTES}\n\n"
                        f'[store]\ndir = "{os.path.join(workdir, f"store{i}")}"\n'
                        f"flush_interval = {STORE_FLUSH_S}\n")

            nets.append((ServerNet(kind, workdir, top=top, tables=tables), workdir))
        # 9a's and 9b's nets start side by side (9a's has stopped before
        # 9b counts the card's compute apps), 9c's once 9b's has stopped;
        # each stops once its part is over
        stack.callback(lambda: [net.stop() for net, _ in nets])
        starts = {0: (0, 1), 2: (2,)}  # the nets started as a part begins
        for k, ((sub, executor, top), (net, workdir)) in enumerate(zip(subs, nets)):
            if k in starts:
                up_s = start_pair([nets[j][0] for j in starts[k]],
                                  f"plane+store node nets ({', '.join(subs[j][0] for j in starts[k])})")
            label = f"plane+store node net ({sub}, executor \"{executor}\")"
            owners = set(p.pid for p in net.procs)  # every server pid of this net: the rings' owners
            try:
                log(f"{label}: {net.n} `server run` processes, [plane] shards = {PLANE_SHARDS}, "
                    f"ring_slots = {RING_SLOTS}, [store] flush_interval = {STORE_FLUSH_S}"
                    + (", thresholds 2" if top else "")
                    + f", up and meshed in {up_s:.1f} s")
                workers = check_workers(net, label) if executor == "process" else None
                if sub == "9c":
                    res = await restart_run(net, clients, rng, 1, restart_per_client,
                                            os.path.join(workdir, "store0"), card_line)
                    owners.update(p.pid for p in net.procs)
                    await check_replay(net, clients, res.pop("per_client"))
                    log(f"{label}: {len(clients)} accounts equal the python-int replay on all "
                        f"{net.n} nodes, node 0 included")
                    name = "plane_store_restart"
                else:
                    try:
                        res = await node_run(net, label, clients, run_a, True, {}, per_batched,
                                             NET_DEADLINE_S)
                    except RuntimeError:
                        await stall_report(net, clients, per_batched, label,
                                           [os.path.join(workdir, f"store{i}") for i in range(net.n)])
                        raise
                    res = node_checks(net, res, by_lanes, card, kind, Counter())
                    await check_replay(net, clients, run_a)
                    busy = [p["kernel_busy_share"] for p in res["nodes"]]
                    log(f"{label}: {res['tx_per_s']:,.0f} tx/s committed; verify kernel launches a "
                        f"node {[p['launches'] for p in res['nodes']]}, kernel busy "
                        f"{[round(100 * b, 2) if b is not None else None for b in busy]}% "
                        f"(phase 3 times); {card_line}")
                    name = f"plane_store_{executor}"
                res["store"] = store_line(net, label, res["transfers"])
                res["workers"] = workers
                out[name] = res
            finally:
                rcs = net.stop()
            check(rcs == [0] * net.n, f"{label}: servers exited with {rcs} on SIGTERM")
            left = rings_of(owners)
            check(not left, f"{label}: rings left in /dev/shm after shutdown: {left}")
    return out


# -- phase 10 --------------------------------------------------------------


BROKER_PER_CLIENT = 256  # 10b: transfers a client through the broker
BROKER_MAX_ENTRIES = 1024  # the broker's --max-entries
CERT_DEADLINE_S = 30.0  # a certificate covers a node's frontier within this
WAIT_FINAL_S = 10.0  # Client.wait_final's timeout through node 1


def node_sign_keys(net: ServerNet) -> list:
    """The nodes' public sign keys, read from their TOMLs: what a light
    client knows from the genesis config, not from any node's answer."""
    from at2_node_tpu_torch.node.config import Config

    keys = []
    for path in net.tomls:
        with open(path) as f:
            keys.append(Config.loads(f.read()).sign_key.public)
    return keys


def certz(net: ServerNet, i: int) -> tuple:
    """Node i's ``/certz``: the document and its chain as Certificates."""
    from at2_node_tpu_torch.finality import Certificate

    doc = json.loads(net.get(i, "/certz"))
    return doc, [Certificate.from_doc(c) for c in doc["chain"]]


def certificate_lag(net: ServerNet, t_last: float, label: str) -> list:
    """Poll every node's ``/certz`` (every NODE_POLL_S) until its newest
    certificate covers its commit frontier; each node's seconds from
    ``t_last`` (the poll that saw the run's last commit) to the poll that
    saw that certificate."""
    lag = [None] * net.n
    t_end = time.perf_counter() + CERT_DEADLINE_S
    while None in lag:
        for i in range(net.n):
            if lag[i] is None:
                doc, chain = certz(net, i)
                if chain and chain[-1].commits >= doc["commits"]:
                    lag[i] = time.perf_counter() - t_last
        if None in lag:
            check(time.perf_counter() < t_end,
                  f"{label}: nodes {[i for i in range(net.n) if lag[i] is None]} hold no certificate "
                  f"covering their frontier {CERT_DEADLINE_S} s after the last commit")
            time.sleep(NODE_POLL_S)
    return lag


def finality_checks(net: ServerNet, keys: list, rng, label: str) -> dict:
    """Every node's chain: non-empty, its newest certificate at the node's
    commit frontier, the four newest certificates alike (one preimage),
    ``verify_chain`` ok under an f+1 light client of the genesis keys and
    under the full member list, refused by both once one co-signature
    byte of the newest certificate is flipped; no equivocation latched."""
    import dataclasses

    from at2_node_tpu_torch.finality import LightVerifier, verify_chain

    subset = LightVerifier(keys, total=net.n)
    full = LightVerifier([], members=keys)
    newest, lengths = [], []
    for i in range(net.n):
        doc, chain = certz(net, i)
        check(chain, f"{label} node {i}: empty certificate chain")
        check(chain[-1].commits == doc["commits"] == net.committed(i),
              f"{label} node {i}: newest certificate at {chain[-1].commits} commits, frontier "
              f"{doc['commits']}, committed {net.committed(i)}")
        for name, verifier in (("f+1", subset), ("full", full)):
            verdict = verify_chain(chain, verifier)
            check(verdict["ok"], f"{label} node {i}: {name} light client refuses the chain: {verdict}")
        sigs = bytearray(chain[-1].sigs)
        sigs[int(rng.integers(0, len(sigs)))] ^= 1 << int(rng.integers(0, 8))
        mutant = chain[:-1] + [dataclasses.replace(chain[-1], sigs=bytes(sigs))]
        strict = LightVerifier(keys, threshold=chain[-1].signer_count())
        for name, verifier in (("full", full), ("every-signer", strict)):
            check(not verify_chain(mutant, verifier)["ok"],
                  f"{label} node {i}: the {name} light client accepts a flipped co-signature byte")
        check(doc["equivocation"] is None, f"{label} node {i}: equivocation {doc['equivocation']}")
        eq = net.metrics(i)["at2_finality_equivocation"]
        check(eq == 0, f"{label} node {i}: finality_equivocation {eq}")
        newest.append(chain[-1])
        lengths.append(len(chain))
    check(len({c.commits for c in newest}) == 1 and len({c.preimage() for c in newest}) == 1,
          f"{label}: the newest certificates differ: {[(c.commits, c.wm_digest.hex()[:12]) for c in newest]}")
    return {"chain_len": lengths, "commits": newest[0].commits, "signers": [c.signer_count() for c in newest]}


def start_broker(net: ServerNet, workdir: str, eager: bool = False):
    """``tools/broker.py`` in front of node 0, as a process (with
    ``--eager`` if asked): its URL and the process once its port accepts."""
    port = free_ports(1)[0]
    argv = [sys.executable, "-m", "at2_node_tpu_torch.tools.broker",
            "--node", f"http://127.0.0.1:{net.rpc_ports[0]}", "--listen", f"127.0.0.1:{port}",
            "--max-entries", str(BROKER_MAX_ENTRIES)] + (["--eager"] if eager else [])
    with open(os.path.join(workdir, "broker.log"), "w") as out:
        proc = subprocess.Popen(argv, stdout=out, stderr=subprocess.STDOUT, env=checkout_env())
    t_end = time.perf_counter() + 60.0
    while not ServerNet._accepts(port):
        check(proc.poll() is None, f"the broker exited with {proc.returncode}")
        check(time.perf_counter() < t_end, "the broker's port never came up")
        time.sleep(0.05)
    return f"127.0.0.1:{port}", proc


def http_json(addr: str, path: str) -> dict:
    """GET ``path`` of the HTTP surface at ``addr`` as JSON (a 503 body too)."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(f"http://{addr}{path}", timeout=30) as r:
            return json.loads(r.read())
    except urllib.error.HTTPError as exc:
        return json.loads(exc.read())


async def broker_run(net: ServerNet, broker: str, seed: int, rng, n_clients: int, per_client: int,
                     n_tampered: int) -> dict:
    """10b: ``tools/loadgen.py`` through the broker (``broker=True``,
    seeded clients, self-transfers of 1), then ``n_tampered`` transfers
    with a flipped signature byte through the broker's gRPC surface, at
    sequences no valid transfer takes."""
    import grpc

    from at2_node_tpu_torch.proto import at2_pb2 as pb
    from at2_node_tpu_torch.proto.rpc import At2Stub
    from at2_node_tpu_torch.tools import loadgen
    from at2_node_tpu_torch.types import transfer_signing_bytes

    total = n_clients * per_client
    clients = loadgen.client_keys(n_clients, seed)
    before = [net.statusz(i) for i in range(net.n)]
    rejected0 = net.metrics(0)["at2_rejected_at_ingress_total"]
    t0 = time.perf_counter()
    load = await loadgen.run_load([f"http://{broker}"], clients=n_clients, tx_per_client=per_client,
                                  broker=True, seed=seed, commit_timeout=NET_DEADLINE_S)
    check(load.submitted == load.committed == total,
          f"broker run: {load.submitted} submitted, {load.committed} of {total} committed")
    t_last = wait_committed(net, [b["stats"]["committed"] + total for b in before], NET_DEADLINE_S)
    wall = t_last - t0
    tampered = []
    for k in range(n_tampered):
        c = k % n_clients
        seq = per_client + 1 + k // n_clients
        recipient = clients[(c + 1) % n_clients].public
        sig = bytearray(clients[c].sign(transfer_signing_bytes(clients[c].public, seq, recipient, 1)))
        sig[int(rng.integers(0, 64))] ^= 1 << int(rng.integers(0, 8))
        tampered.append(pb.SendAssetRequest(sender=clients[c].public, sequence=seq,
                                            recipient=recipient, amount=1, signature=bytes(sig)))
    async with grpc.aio.insecure_channel(broker) as channel:
        stub = At2Stub(channel)
        for req in tampered:
            await stub.SendAsset(req)  # the broker takes it: only the node verifies
    t_end = time.perf_counter() + 10.0
    while net.metrics(0)["at2_rejected_at_ingress_total"] < rejected0 + n_tampered:
        check(time.perf_counter() < t_end,
              f"broker run: node 0 refused {net.metrics(0)['at2_rejected_at_ingress_total'] - rejected0} "
              f"of {n_tampered} tampered transfers in 10 s")
        await asyncio.sleep(NODE_POLL_S)
    return {"clients": clients, "transfers": total, "wall_s": wall, "tx_per_s": total / wall,
            "loadgen_tx_per_s": load.committed_tx_per_sec, "loadgen_commit_s": load.commit_seconds,
            "t_last": t_last, "before": before,
            "rejected": net.metrics(0)["at2_rejected_at_ingress_total"] - rejected0}


def finality_net(kind: str, workdir: str) -> ServerNet:
    """Phase 10's net: phase 6's with ``[finality] enabled``."""
    return ServerNet(kind, workdir, tables=lambda i: "[finality]\nenabled = true\n")


async def finality_broker_path(seed: int, by_lanes, card, card_line: str, net: ServerNet, kind: str = "cuda",
                               n_clients: int = NET_CLIENTS, per_batched: int = NET_PER_CLIENT_BATCHED,
                               broker_per_client: int = BROKER_PER_CLIENT,
                               n_tampered: int = NODE_TAMPERED, capture_to: str | None = None) -> dict:
    """Phase 10 on ``net``, a started ``finality_net`` (phase 6's net with
    ``[finality] enabled``; stopped here): 10a, run A, then the
    certificates; 10b, a broker in front of node 0. With ``capture_to``,
    node 0's ``/capturez`` is written there at the end of 10a, for phase
    11c to replay in the sim."""
    from at2_node_tpu_torch.client import Client
    from at2_node_tpu_torch.finality import LightVerifier
    from at2_node_tpu_torch.tools.trace_collect import stitch

    rng = np.random.default_rng(seed + 6)  # phase 6's: the same clients and run A
    clients, run_a, _, _ = node_traffic(rng, n_clients, per_batched, NET_PER_CLIENT_PER_TX, NODE_TAMPERED)
    rng = np.random.default_rng(seed + 10)
    out = {}
    broker_proc = None
    try:
        workdir = net.workdir
        keys = node_sign_keys(net)
        label = "finality node net (10a, SendAssetBatch)"
        log(f"{label}: {net.n} `server run` processes, [finality] enabled = true, audit_every 256 "
            f"(the default)")
        run = await node_run(net, label, clients, run_a, True, {}, per_batched, NET_DEADLINE_S)
        # a wallet's light client: the four genesis sign keys, any
        # f + 1 = 2 valid co-signatures
        light = LightVerifier(keys, total=net.n)
        t_final = time.perf_counter()

        async def wait_final():
            async with Client(f"http://127.0.0.1:{net.rpc_ports[1]}") as conn:
                cert = await conn.wait_final(clients[0].public, per_batched, verifier=light,
                                             timeout_s=WAIT_FINAL_S)
                _, _, frontier, _ = await conn.get_certificates()
            return cert, frontier, time.perf_counter() - t_final

        (cert, frontier, final_s), lag = await asyncio.gather(
            wait_final(), asyncio.to_thread(certificate_lag, net, run["t_last"], label))
        check(cert.commits >= run["transfers"],
              f"{label}: wait_final returned a certificate at {cert.commits} commits")
        res = node_checks(net, run, by_lanes, card, kind, Counter())
        await check_replay(net, clients, run_a)
        fin = finality_checks(net, keys, rng, label)
        res.update(certificate_lag_s=lag, wait_final_s=final_s, finality=fin)
        log(f"{label}: {res['tx_per_s']:,.0f} tx/s committed with [finality] enabled; certificate "
            f"lag (last commit to the certificate covering it) {[round(x, 3) for x in lag]} s a node; "
            f"chains of {fin['chain_len']} certificates, the newest at {fin['commits']} commits with "
            f"{fin['signers']} signers, one preimage on all {net.n} nodes, verified by an f+1 and a "
            f"full light client and refused with one co-signature byte flipped; Client.wait_final "
            f"through node 1 returned a certificate at {cert.commits} commits (frontier {frontier}) "
            f"in {final_s:.3f} s; verify kernel launches a node {[p['launches'] for p in res['nodes']]}; "
            f"{card_line}")
        out["net_finality"] = res
        if capture_to is not None:
            capture = net.get(0, "/capturez")
            with open(capture_to, "w") as f:
                f.write(capture)
            log(f"{label}: node 0's /capturez ({len(json.loads(capture)['records'])} records, "
                f"{len(capture):,} bytes) written for phase 11c")

        label = "broker node net (10b, loadgen --broker)"
        broker, broker_proc = start_broker(net, workdir)
        b = await broker_run(net, broker, seed + 11, rng, n_clients, broker_per_client, n_tampered)
        lag_b = certificate_lag(net, b["t_last"], label)
        check(b["rejected"] == n_tampered,
              f"{label}: node 0 refused {b['rejected']} of {n_tampered} tampered transfers")
        await check_sequences(net, b["clients"], broker_per_client)
        await check_replay(net, b["clients"], [[(seq, kp.public, 1) for seq in
                                               range(1, broker_per_client + 1)] for kp in b["clients"]])
        await check_replay(net, clients, run_a)
        k1 = [launches_since(net, i, b["before"][i], label) for i in range(net.n)]
        st0, st = b["before"][0]["stats"], net.stats(0)
        distilled = st["distilled_batches_rx"] - st0["distilled_batches_rx"]
        check(distilled > 0, f"{label}: node 0 took no distilled batch")
        bstat = http_json(broker, "/statusz")
        health = http_json(broker, "/healthz")
        check(bstat["stats"]["broker_entries_tx"] == b["transfers"] + n_tampered,
              f"{label}: the broker forwarded {bstat['stats']['broker_entries_tx']} entries, "
              f"not {b['transfers'] + n_tampered}")
        check(health["role"] == "broker" and health["status"] == "ok", f"{label}: broker /healthz {health}")
        dumps = [json.loads(net.get(i, "/tracez")) for i in range(net.n)] + [http_json(broker, "/tracez")]
        stitched = stitch(dumps)
        check(stitched["coverage"]["with_broker"] >= 1,
              f"{label}: no transfer stitched across the broker hop: {stitched['coverage']}")
        fin_b = finality_checks(net, keys, rng, label)
        top = subprocess.run(
            [sys.executable, "-m", "at2_node_tpu_torch.tools.top", "--once", "--no-clear",
             "--cert-lag-deadline", "0", *[f"127.0.0.1:{p}" for p in net.rpc_ports], broker],
            capture_output=True, text=True, env=checkout_env(), timeout=120)
        check(top.returncode == 0 and "final" in top.stdout,
              f"{label}: top.py --once exited {top.returncode}: {top.stdout[-2000:]} {top.stderr[-2000:]}")
        hop = stitched.get("broker_hop", {}).get("segments", {})
        log(f"{label}: {b['transfers']} transfers from {n_clients} clients through the broker "
            f"(--max-entries {BROKER_MAX_ENTRIES}) committed on all {net.n} nodes in "
            f"{b['wall_s']:.3f} s = {b['tx_per_s']:,.0f} tx/s (loadgen's own window, after its "
            f"directory warm-up, to node 0 through the broker: {b['loadgen_tx_per_s']:,.0f} tx/s); "
            f"node 0 took {distilled} distilled batches and refused the {n_tampered} tampered "
            f"transfers; verify kernel launches a node {[x['launches'] for x in k1]} (= batches "
            f"{[x['batches'] for x in k1]}); the broker forwarded {bstat['stats']['broker_entries_tx']} "
            f"entries in {bstat['stats']['broker_batches_tx']} frames; {stitched['coverage']['with_broker']} "
            f"transfers stitched across the broker hop; certificate lag {[round(x, 3) for x in lag_b]} s "
            f"a node; {card_line}")
        log(f"{label}: broker hop segments {json.dumps(hop, sort_keys=True)}")
        log(f"{label}: top.py --once exited 0:")
        for line in top.stdout.rstrip().splitlines():
            log("  " + line)
        out["net_broker"] = {
            "launches": sum(x["launches"] for x in k1), "tx_per_s": b["tx_per_s"],
            "wall_s": b["wall_s"], "transfers": b["transfers"],
            "loadgen_tx_per_s": b["loadgen_tx_per_s"], "distilled_batches": distilled,
            "rejected": b["rejected"], "nodes": k1, "certificate_lag_s": lag_b,
            "broker_entries_tx": bstat["stats"]["broker_entries_tx"],
            "broker_batches_tx": bstat["stats"]["broker_batches_tx"],
            "with_broker": stitched["coverage"]["with_broker"], "finality": fin_b,
        }
    finally:
        brc = None
        if broker_proc is not None:
            import signal

            broker_proc.send_signal(signal.SIGINT)
            try:
                brc = broker_proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                broker_proc.kill()
                brc = broker_proc.wait()
        rcs = net.stop()
    check(rcs == [0] * net.n, f"phase 10: servers exited with {rcs} on SIGTERM")
    check(broker_proc is None or brc == 0, f"phase 10: the broker exited with {brc} on SIGINT")
    log("phase 10: every server exited 0 on SIGTERM, the broker 0 on SIGINT")
    return out


# -- phase 8 ---------------------------------------------------------------


def seam_lanes(n: int, shard_counts) -> list:
    """The lanes on both sides of every shard seam of every pool size: a
    pool of k pads n to a multiple of 8 k lanes and cuts it in k."""
    from at2_node_tpu_torch.parallel import pool

    lanes = set()
    for k in shard_counts:
        q = pool._pool_quantum(k)
        per = -(-n // q) * q // k
        for s in range(per, n, per):
            lanes.update((s - 1, s))
    return sorted(lanes)


def pool_launch_ms(torch, host, devs, streams, reps: int) -> float:
    """The whole pool launch on the device clock: every shard's upload,
    kernel and copy back, each shard on its streams, from an event that
    every stream waits for to one recorded after every shard's last copy;
    the mean over ``reps`` launches."""
    from at2_node_tpu_torch.parallel import pool

    cur = torch.cuda.current_stream()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record(cur)
    for copy_s, compute_s in streams:
        copy_s.wait_event(start)
        compute_s.wait_event(start)
    for _ in range(reps):
        handles = pool.verify_sharded_packed(host, devs, streams)
    for h in handles:
        cur.wait_event(h.done)
    end.record(cur)
    end.synchronize()
    return start.elapsed_time(end) / reps


def pool_vs_kernel(torch, mat: Material, rng, by_lanes: dict) -> dict:
    """Phase 8a: pools of POOL_SHARDS shards on cuda:0 against the verify
    kernel, its plain version on the card and the expected verdicts, at
    phase 3's shapes; the pool's launch timed at POOL_TIMED_LANES."""
    from at2_node_tpu_torch.ops import cuda_verify
    from at2_node_tpu_torch.ops import ed25519 as v
    from at2_node_tpu_torch.parallel import pool

    pools = {k: pool.make_pool_devices(["cuda:0"] * k) for k in POOL_SHARDS}
    streams = {k: pool.shard_streams(devs) for k, devs in pools.items()}
    mismatches, max_err = 0, 0
    by_shards: dict = {}
    plain_ms: dict = {}
    for n in KERNEL_LANES:
        items, expect, pad = mat.batch(n, rng)
        seams = seam_lanes(n, POOL_SHARDS)
        for j, lane in enumerate(seams):  # a tampered lane each side of a seam
            items[lane] = mat.tampered["r_flip" if j % 2 else "s_flip"][j % len(mat.tampered["r_flip"])]
            expect[lane], pad[lane] = False, False
        rows = np.empty((n, v.PACKED_WIDTH), dtype=np.uint8)
        v.fill_packed([i[0] for i in items], [i[1] for i in items], [i[2] for i in items], rows)
        rows[pad, 128] = 0
        dev = torch.from_numpy(rows).cuda()
        k1_bytes = cuda_verify.verify_packed(dev).cpu().numpy()
        plain = v.verify_packed(dev).cpu().numpy()
        k1 = np.unpackbits(k1_bytes, count=n).astype(bool)
        p_bits = np.unpackbits(plain, count=n).astype(bool)
        line = []
        for k, devs in pools.items():
            q = pool._pool_quantum(k)
            padded = np.zeros((-(-n // q) * q, v.PACKED_WIDTH), dtype=np.uint8)
            padded[:n] = rows
            host = torch.from_numpy(padded).pin_memory()
            bits = pool.finish_sharded(pool.verify_sharded_packed(host, devs, streams[k]))
            ok = np.unpackbits(bits, count=padded.shape[0]).astype(bool)
            _, count = pool.verify_and_count(host, devs, streams[k])
            bad = int((ok[:n] != k1).sum() + (ok[:n] != p_bits).sum() + (ok[:n] != expect).sum()
                      + ok[n:].sum()) + int(count != int(ok.sum()))
            err = int(np.abs(bits[:len(k1_bytes)].astype(int) - k1_bytes.astype(int)).max())
            mismatches += bad
            max_err = max(max_err, err)
            line.append(f"{k} shard{'s' if k > 1 else ''}: {bad}")
            if n in POOL_TIMED_LANES:
                reps = max(3, min(50, 200_000 // n))
                pool_launch_ms(torch, host, devs, streams[k], reps)  # warm the allocators
                ms = pool_launch_ms(torch, host, devs, streams[k], reps)
                by_shards.setdefault(n, {})[k] = ms
        log(f"pool vs kernel {n:6d} lanes ({len(seams)} seam lanes tampered): mismatches by pool "
            f"size {', '.join(line)}; count = popcount")
        if n in POOL_TIMED_LANES:
            reps = max(3, min(50, 200_000 // n))
            k1_ms = cuda_ms(torch, lambda: cuda_verify.verify_packed(dev), reps)
            by_shards[n]["k1_kernel_ms"] = k1_ms
            if n == max(POOL_TIMED_LANES):
                # the pool's plain version: the plain verify of each shard
                for k in POOL_SHARDS:
                    shards = [s.contiguous() for s in dev.chunk(k)]
                    plain_ms[k] = cuda_ms(torch, lambda: [v.verify_packed(s) for s in shards], 1)
                log(f"pool plain version {n:6d} lanes (the plain verify a shard, on the card): "
                    + ", ".join(f"{k} shard{'s' if k > 1 else ''} {ms:.1f} ms"
                                for k, ms in plain_ms.items()))
            log(f"pool launch {n:6d} lanes (uploads, kernels, copies back; CUDA events): "
                + ", ".join(f"{k} shard{'s' if k > 1 else ''} {by_shards[n][k]:.3f} ms"
                            for k in POOL_SHARDS)
                + f"; the kernel alone on rows already on the card {k1_ms:.3f} ms "
                f"(bound {by_lanes[n]['bound_ms']:.3f} ms)")
    check(mismatches == 0, f"pool, verify kernel, plain version and expected verdicts differ: {mismatches}")
    return {"mismatches": mismatches, "max_abs_err": max_err, "by_shards": by_shards,
            "plain_ms": plain_ms}


def replay_phase() -> dict:
    """Phase 8b: the 1M replay through the pool of one shard on cuda:0; the
    verify kernel's launch count is set to 0 just before and read just
    after (the warm-up batch included)."""
    from at2_node_tpu_torch.ops import cuda_verify
    from at2_node_tpu_torch.tools import scale_demo

    cuda_verify.launches = 0
    out = scale_demo._phase_replay(REPLAY_SIGNATURES, bucket=REPLAY_BUCKET, devices=["cuda:0"])
    launches = cuda_verify.launches
    rounds = REPLAY_SIGNATURES // REPLAY_BUCKET
    check(out["replayed_signatures"] == REPLAY_SIGNATURES == out["verified_ok"],
          f"replay: {out['verified_ok']} of {out['replayed_signatures']} verified")
    check(launches == rounds + 1, f"replay: {launches} kernel launches for {rounds} + 1 batches")
    log(f"replay: {out['verified_ok']:,} of {REPLAY_SIGNATURES:,} signatures verified through the pool "
        f"of 1 in {out['seconds']:.3f} s = {out['verifies_per_sec']:,.0f} sigs/s (host clock, "
        f"{REPLAY_BUCKET}-lane buckets, host prep included); {launches} kernel launches")
    return {**out, "launches": launches}


async def scale_net_phase(seed: int, by_lanes: dict) -> dict:
    """Phase 8c: 32 in-process nodes behind one pool built from the
    ``[verifier] kind = "pool"`` table. The kernel's launch count is set to
    0 just before and read just after (the pool's warm-up included)."""
    import logging
    import resource

    from at2_node_tpu_torch.ops import cuda_verify
    from at2_node_tpu_torch.tools import _common, scale_demo

    need = scale_demo.open_files_needed(SCALE_NODES)
    soft0, hard0 = resource.getrlimit(resource.RLIMIT_NOFILE)
    soft, hard = scale_demo.raise_open_files(need)
    log(f"scale net: open-file limit {soft0} (hard {hard0}) raised to {soft}; "
        f"{SCALE_NODES} nodes need about {need}; ephemeral ports {_common.ephemeral_range()}, "
        f"the nodes listen outside them where there is room")
    # loadgen's transfers go to their sender: the ledger notes each one
    logging.getLogger("at2_node_tpu_torch.ledger.accounts").setLevel(logging.ERROR)
    f = (SCALE_NODES - 1) // 3
    cuda_verify.launches = 0
    net = await scale_demo._phase_net(
        SCALE_NODES, SCALE_CLIENTS, SCALE_PER_CLIENT, 2 * f + 1, pool_batch=SCALE_POOL_BATCH,
        seed=seed + 8, commit_timeout=SCALE_DEADLINE_S)
    launches = cuda_verify.launches
    want = SCALE_CLIENTS * SCALE_PER_CLIENT
    shards = len(net["pool_devices"])
    check(net["committed"] == net["submitted"] == want,
          f"scale net: {net['committed']} of {want} transfers committed")
    check(net["ledgers_equal_replay_on_all_nodes"], "scale net: a ledger differs from the replay")
    check(net["pool_batches"] > 0, "scale net: the pool dispatched no batch")
    check(net["kernel_launches"] == net["pool_batches"] * shards,
          f"scale net: {net['pool_batches']} batches x {shards} shards but "
          f"{net['kernel_launches']} kernel launches")
    shard_lanes = SCALE_POOL_BATCH // shards
    busy = (net["kernel_launches_in_window"] * by_lanes[shard_lanes]["ms"]
            / (1e3 * net["commit_seconds"]))
    log(f"scale net: {want} transfers from {SCALE_CLIENTS} clients committed on all {SCALE_NODES} "
        f"nodes (thresholds {2 * f + 1}; the net came up at start {net['net_starts']}) in "
        f"{net['commit_seconds']:.3f} s = "
        f"{net['committed_tx_per_sec']:,.1f} tx/s (first submission to the last sequence read on the "
        f"last node; every ledger equal to the replay {net['all_nodes_extra_seconds']:.3f} s later); "
        f"pool {net['pool_devices']}: {net['pool_batches']} batches, {net['pool_signatures']:,} "
        f"signatures, occupancy {net['pool_batch_occupancy']:.4f}, dispatch {net['pool_avg_dispatch_ms']:.3f} "
        f"ms a batch (counted once the pool settled); {net['kernel_launches_in_window']} kernel launches in the window, "
        f"{net['kernel_launches']} once settled, {launches} with the warm-up; kernel busy "
        f"{100 * busy:.2f}% of the window (phase 3 times)")
    return {**net, "launches": launches, "kernel_busy_share": busy,
            "open_files": {"soft_before": soft0, "soft": soft, "hard": hard, "need": need}}


def entry_phase(torch) -> dict:
    """Phase 8d: the entry's function on its example arguments on the card,
    then the dry run over four shards of cuda:0. The kernel's launch count
    is set to 0 just before and read just after."""
    from at2_node_tpu_torch import entry
    from at2_node_tpu_torch.ops import cuda_verify

    cuda_verify.launches = 0
    fn, args = entry.entry()
    check(all(a.device.type == "cuda" for a in args), "entry's example arguments are not on the card")
    bits = fn(*args)
    torch.cuda.synchronize()
    ok = np.unpackbits(bits.cpu().numpy(), count=args[0].shape[0]).astype(bool)
    check((ok == entry._expected(8, args[0].shape[0])).all(), f"entry: verdicts {ok.tolist()}")
    entry.dryrun_multichip(4, devices=["cuda:0"] * 4)
    launches = cuda_verify.launches
    check(launches == 1 + 4, f"entry and dry run: {launches} kernel launches, expected 5")
    log(f"entry: the verify kernel on 8 real lanes (lane 1 tampered) in a 64-row bucket gave the "
        f"expected verdicts; dryrun_multichip(4) over cuda:0 x 4 passed; {launches} kernel launches")
    return {"launches": launches}


def pool_path(torch, mat: Material, rng, seed: int, by_lanes: dict) -> dict:
    t0 = time.perf_counter()
    cmp = pool_vs_kernel(torch, mat, rng, by_lanes)
    replay = replay_phase()
    net = asyncio.run(scale_net_phase(seed, by_lanes))
    ent = entry_phase(torch)
    log(f"phase 8 (the device pool, BASELINE config 5) took {time.perf_counter() - t0:.1f} s")
    return {"compare": cmp, "replay": replay, "scale_net": net, "entry": ent}


# -- phase 11 --------------------------------------------------------------


# The sim gates of the reference's scripts/ci.sh and what the JAX package's
# CLIs print for them under PYTHONHASHSEED=0 (the full grid is the hash that
# BENCH_SCENARIOS.json banks). The port's CLIs must print the same. "short"
# gates also run in the tests on the CPU; "runs" is how often phase 11 runs
# each (twice where scripts/ci.sh checks that a seed reproduces its hash).
SIM_GATES = {
    "determinism": {
        "ci": "scripts/ci.sh:61-77", "tool": "sim_run", "argv": ("--seed", "7", "--episodes", "3"),
        "hash": "3a2947ccb595d15502516cf2a87cec418284cdbb82c6fc2a9db5a6f0305fb39b", "runs": 2, "short": True},
    "campaign": {
        "ci": "scripts/ci.sh:108-114", "tool": "sim_run", "argv": ("--seed", "1", "--episodes", "50"),
        "hash": "21ee6382d32a3ff9217e1fb10f72cde27e9f3c946fb60a62649f6786de3a3578", "runs": 1, "short": False},
    "broker": {
        "ci": "scripts/ci.sh:124-142", "tool": "sim_run", "argv": ("--seed", "11", "--episodes", "5", "--broker"),
        "hash": "858512b61c24ef5aecc8b5e821786f5cd911730d7379c9509914638e8f51a9ac", "runs": 2, "short": True},
    "restart": {
        "ci": "scripts/ci.sh:144-163", "tool": "sim_run",
        "argv": ("--seed", "13", "--episodes", "4", "--durability"),
        "hash": "70c4ae793a812572bb427f402b34e07c50f4706622fb6c4ce87db96f8128bb0a", "runs": 2, "short": True},
    "salting": {
        "ci": "scripts/ci.sh:165-188", "tool": "sim_run", "argv": ("--seed", "7", "--episodes", "3", "--salting"),
        "hash": "018ec3d9a7659dd67c45d172ae86360600324847d8ddcfb991d7d731da2e2f3e", "runs": 2, "short": True},
    "grid_smoke": {
        "ci": "scripts/ci.sh:190-206", "tool": "scenario_grid",
        "argv": ("--seed", "7", "--smoke", "--txs", "24", "--duration", "8"),
        "hash": "0833303a755eecd97dea660db52abe3ee32da403ada454760ff5329d3371eb26", "runs": 2, "short": True},
    "grid_full": {
        "ci": "BENCH_SCENARIOS.json", "tool": "scenario_grid", "argv": ("--seed", "1"),
        "hash": "45c99be73b3bb8dbe48d8f16a0818bf4c2b2cd334e4bd019cd13ffcbd9a6cc1c", "runs": 1, "short": False},
    "wan_steady": {
        "ci": "scripts/ci.sh:208-243", "tool": "scenario_grid",
        "argv": ("--seed", "7", "--replay", "wan3/steady/none+wan", "--txs", "24", "--duration", "8", "--json"),
        "hash": "066b7d9b3db0e231ee92adddb6ad8970cfd26d72b78f5850b2c6b506d51586f1", "p99_ms": 307.873,
        "runs": 2, "short": True},
    "wan_cut": {
        "ci": "scripts/ci.sh:208-243", "tool": "scenario_grid",
        "argv": ("--seed", "7", "--replay", "wan3/steady/cut+wan", "--txs", "24", "--duration", "8", "--json"),
        "hash": "67c93ae0c81681459443d0dd9a0d7e1caa9b565a309179944a64a16ba70bca1c", "p99_ms": 507.459,
        "runs": 2, "short": True},
    "overload": {
        "ci": "scripts/ci.sh:245-284", "tool": "overload_ab",
        "argv": ("--seed", "5", "--clients", "60", "--crowd", "40", "--txs", "80", "--workload", "flash_crowd",
                 "--quiet", "--json"),
        "hash": "831c18351bc94c47ce01dd1f954881a1387726f26a260fb4bf26c8276b2f51ca", "runs": 2, "short": True},
}
# scripts/ci.sh's bar for the WAN steady cell with the [wan] levers on
SIM_WAN_P99_MS = 1000.0
# bench_finality at its defaults (4 nodes, 48 transfers, audit_every 8,
# seed 7): the reference's production block and wire bytes
SIM_FINALITY = {
    "production": {"certificates": 24, "certified": 48, "frontier": 48, "lag_p50_s": 0.05,
                   "lag_p99_s": 0.05, "lag_samples": 24, "violations": []},
    "cert_wire_bytes": 369,
    "cosig_wire_bytes": 265,
}
# the planted-breach artifact check of scripts/ci.sh:79-106, on the port
SIM_BREACH_CHECK = """
from at2_node_tpu_torch.sim.campaign import planted_breach_episode

r = planted_breach_episode(20260805)
assert r.violations, "planted breach must violate invariants"
obs = r.obs
assert obs is not None, "failing episode must attach obs artifact"
recs = obs["recorders"]
assert len(recs) == 4, f"want 4 recorder dumps, got {len(recs)}"
for dump in recs:
    assert dump["recorder"]["events"], f"node {dump['node']}: empty flight-recorder ring"
offending = [tx for tx in obs["stitched"]["txs"] if tx["seq"] == 1]
assert offending, "stitched timeline must contain the offending tx"
assert offending[0]["nodes"] >= 2, "timeline must span multiple nodes"
assert offending[0]["stragglers"], "straggler attribution missing"
print(len(r.violations), offending[0]["nodes"])
"""
# sim processes at once: beside phases 2-3c, half the card machine's eight
# cores, so that the builds and phase 3's host thread keep a core each
SIM_WORKERS = 4
SIM_TIMEOUT_S = 600


def sim_tool(module: str, argv) -> dict:
    """One port sim CLI run as a user runs it: ``python -m`` from this
    checkout, the hash seed left to the tool (it re-executes itself under
    PYTHONHASHSEED=0)."""
    env = checkout_env()
    env.pop("PYTHONHASHSEED", None)
    cmd = [sys.executable, "-m", module, *argv] if module else [sys.executable, *argv]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=SIM_TIMEOUT_S)
    return {"rc": proc.returncode, "out": proc.stdout, "err": proc.stderr, "s": time.perf_counter() - t0}


def sim_gate_result(name: str, run: dict) -> dict:
    """A gate run's hash and its own verdict; raises unless the run passed
    its tool's own bar (exit 0, no failing episode, no breaching cell)."""
    gate = SIM_GATES[name]
    tail = f"{run['out'][-1500:]} {run['err'][-1500:]}"
    check(run["rc"] == 0, f"sim gate {name}: exit {run['rc']}: {tail}")
    if gate["tool"] == "sim_run":
        m = re.search(r"(\d+) failures, hash ([0-9a-f]{64})", run["out"])
        check(m is not None and m.group(1) == "0", f"sim gate {name}: {tail}")
        return {"hash": m.group(2)}
    if gate["tool"] == "overload_ab":
        doc = json.loads(run["out"])
        check(doc["ok"], f"sim gate {name}: the A/B claim failed: {tail}")
        arms = {c["arm"]: c for c in doc["cells"]}
        return {"hash": doc["ab_hash"], "arms": {a: {"steady_p99_ms": c["steady_p99_ms"], "slo_ok": c["slo_ok"],
                                                     "shed": c["shed"], "committed": c["committed"],
                                                     "offered": c["offered"]} for a, c in arms.items()}}
    if "--replay" in gate["argv"]:
        cell = json.loads(run["out"])
        check(not cell["violations"] and cell["slo"]["ok"], f"sim gate {name}: {tail}")
        return {"hash": cell["trace_hash"], "p99_ms": cell["latency_p99_ms"],
                "committed": cell["committed"], "offered": cell["offered"]}
    m = re.search(r"(\d+) cells, (\d+) breaching, hash ([0-9a-f]{64})", run["out"])
    check(m is not None and m.group(2) == "0", f"sim gate {name}: {tail}")
    return {"hash": m.group(3), "cells": int(m.group(1))}


def capture_kinds(path: str) -> tuple:
    """A /capturez dump's record count and its messages counted by kind
    name: a frame may coalesce many messages, and a record's kind is its
    first message's."""
    from at2_node_tpu_torch.broadcast import messages as m

    names = {getattr(m, k): k for k in ("GOSSIP", "ECHO", "READY", "REQUEST", "HIST_IDX_REQ", "HIST_IDX",
                                        "HIST_REQ", "HIST_BATCH", "BATCH", "BATCH_ECHO", "BATCH_READY",
                                        "BATCH_REQ", "DIR_ANNOUNCE", "CONFIG_TX", "BEACON", "CERT_SIG")}
    with open(path) as f:
        records = json.load(f)["records"]
    kinds: Counter = Counter()
    for r in records:
        for msg in m.parse_frame(bytes.fromhex(r[3])):
            kind = msg.encode()[0]
            kinds[names.get(kind, f"kind {kind}")] += 1
    return len(records), kinds


def sim_start(pool) -> dict:
    """Phase 11's runs that need nothing of the card or of another phase
    (11a, 11b, 11d), submitted to ``pool``, the longest first so that the
    pool ends together: their futures by (name, run)."""
    jobs = {}
    for name, gate in SIM_GATES.items():
        for k in range(gate["runs"]):
            jobs[(name, k)] = (f"at2_node_tpu_torch.tools.{gate['tool']}", gate["argv"])
    jobs[("breach", 0)] = (None, ("-c", SIM_BREACH_CHECK))
    jobs[("finality", 0)] = ("at2_node_tpu_torch.tools.bench_finality", ())
    order = sorted(jobs, key=lambda j: j[0] not in ("campaign", "grid_full"))
    return {j: pool.submit(sim_tool, *jobs[j]) for j in order}


def sim_path(capture: str | None, card: str, started: dict) -> dict:
    """Phase 11: the port's deterministic simulator through its five CLIs,
    each a subprocess, SIM_WORKERS at a time. 11a the campaigns and the
    planted breach, 11b the grids and the overload A/B, 11c phase 10a's
    capture replayed, 11d bench_finality; every hash against SIM_GATES.
    ``started``: ``sim_start``'s futures of 11a, 11b and 11d."""
    t0 = time.perf_counter()
    runs = {j: f.result() for j, f in started.items()}
    if capture is not None:
        runs[("capture", 0)] = sim_tool("at2_node_tpu_torch.tools.capture_replay",
                                        (capture, "--repeat", "2", "--json"))
    out: dict = {"gates": {}, "seconds": {}}

    for name, gate in SIM_GATES.items():
        res = [sim_gate_result(name, runs[(name, k)]) for k in range(gate["runs"])]
        hashes = [r["hash"] for r in res]
        secs = [runs[(name, k)]["s"] for k in range(gate["runs"])]
        check(len(set(hashes)) == 1, f"sim gate {name}: the same seed gave {hashes}")
        check(hashes[0] == gate["hash"], f"sim gate {name}: hash {hashes[0]}, the reference's {gate['hash']}")
        extra = ""
        if "p99_ms" in gate:
            check(all(r["p99_ms"] == gate["p99_ms"] for r in res), f"sim gate {name}: p99 {res}")
            check(all(r["committed"] == r["offered"] for r in res), f"sim gate {name}: lost transfers {res}")
            extra = f"; p99 {res[0]['p99_ms']} ms, {res[0]['committed']}/{res[0]['offered']} committed"
            if name == "wan_steady":
                check(res[0]["p99_ms"] < SIM_WAN_P99_MS, f"sim gate {name}: p99 {res[0]['p99_ms']} ms")
                extra += f" (< {SIM_WAN_P99_MS:.0f} ms)"
        if "arms" in res[0]:
            arms = res[0]["arms"]
            check(not arms["uncontrolled"]["slo_ok"] and arms["controlled"]["slo_ok"],
                  f"sim gate {name}: the arms {arms}")
            extra = ("; uncontrolled arm breaches (steady p99 "
                     f"{arms['uncontrolled']['steady_p99_ms']} ms), controlled arm holds (steady p99 "
                     f"{arms['controlled']['steady_p99_ms']} ms, shed {arms['controlled']['shed']})")
        if "cells" in res[0]:
            extra = f"; {res[0]['cells']} cells, none breaching"
        out["gates"][name] = {"hash": hashes[0], "runs": gate["runs"], **{k: v for k, v in res[0].items()
                                                                          if k != "hash"}}
        out["seconds"][name] = secs
        log(f"sim {name} ({gate['ci']}): {gate['tool']} {' '.join(gate['argv'])}: exit 0, hash "
            f"{hashes[0][:16]}… = the reference's"
            + (f", {gate['runs']} runs alike" if gate["runs"] > 1 else "")
            + f"{extra}; {', '.join(f'{s:.1f}' for s in secs)} s")

    br = runs[("breach", 0)]
    check(br["rc"] == 0, f"sim planted breach: exit {br['rc']}: {br['err'][-3000:]}")
    n_viol, n_nodes = (int(x) for x in br["out"].split())
    out["gates"]["planted_breach"] = {"violations": n_viol, "offending_tx_nodes": n_nodes}
    out["seconds"]["planted_breach"] = [br["s"]]
    log(f"sim planted breach (scripts/ci.sh:79-106): planted_breach_episode(20260805) gave {n_viol} "
        f"violations, 4 flight-recorder dumps and the offending transfer stitched across {n_nodes} nodes; "
        f"{br['s']:.1f} s")

    if capture is not None:
        cr = runs[("capture", 0)]
        check(cr["rc"] == 0, f"sim capture replay: exit {cr['rc']}: {cr['err'][-3000:]}")
        verdict = json.loads(cr["out"])
        check(verdict["deterministic"], f"sim capture replay: two replays differ: {cr['err'][-2000:]}")
        check(not verdict["violations"], f"sim capture replay: violations {verdict['violations']}")
        n_records, kinds = capture_kinds(capture)
        for what, names in (("payload", ("GOSSIP", "BATCH")), ("echo", ("ECHO", "BATCH_ECHO")),
                            ("ready", ("READY", "BATCH_READY")), ("co-signature", ("CERT_SIG",))):
            check(any(kinds[n] for n in names), f"sim capture replay: no {what} message in {dict(kinds)}")
        out["capture"] = {"records": n_records, "messages": dict(kinds),
                          "verdict_sha256": verdict["verdict_sha256"], "injected": verdict["injected"],
                          "committed": verdict["committed"]}
        out["seconds"]["capture"] = [cr["s"]]
        log(f"sim capture replay (11c): node 0's /capturez from phase 10a ({n_records} records holding "
            f"{', '.join(f'{k} {c}' for k, c in sorted(kinds.items()))}) replayed twice into a fresh 4-node "
            f"sim by capture_replay --repeat 2: verdict {verdict['verdict_sha256'][:16]}… both times, no "
            f"invariant violation, committed {verdict['committed']}; {cr['s']:.1f} s")

    fb = runs[("finality", 0)]
    check(fb["rc"] == 0, f"sim bench_finality: exit {fb['rc']}: {fb['err'][-3000:]}")
    doc = json.loads(fb["out"])
    for key, want in SIM_FINALITY.items():
        check(doc[key] == want, f"sim bench_finality: {key} {doc[key]}, the reference's {want}")
    out["finality"] = {**SIM_FINALITY, "verify": doc["verify"]}
    out["seconds"]["finality"] = [fb["s"]]
    prod = doc["production"]
    log(f"sim bench_finality (11d, defaults): {prod['certificates']} certificates, lag p50 "
        f"{prod['lag_p50_s']} s p99 {prod['lag_p99_s']} s (virtual), a {doc['cert_wire_bytes']} B certificate "
        f"and a {doc['cosig_wire_bytes']} B co-signature = the reference's; light-client verify "
        f"{doc['verify']['subset_per_s']}/s (f+1 subset) and {doc['verify']['full_per_s']}/s (full member "
        f"list) on the host CPU of the card's machine ({card}); {fb['s']:.1f} s")
    out["phase_s"] = time.perf_counter() - t0
    log(f"phase 11 (the deterministic simulator) took {out['phase_s']:.1f} s"
        + (" past the build, where its 11a, 11b and 11d runs started" if started is not None else "")
        + f", {SIM_WORKERS} sim processes at a time on the host CPU; {card}")
    return out


# -- phase 12 --------------------------------------------------------------


TOOLS_TRIALS = 1  # 12a: verify_bench's trials (cut from its default 3 to keep a call under 700 s)
TOOLS_COMPOSE_TRIALS = 1  # 12d: e2e_bench --compose's verify grid trials (cut from 3: printed only)
TOOLS_PLANE_REPEAT = 1  # 12c: compare-obs and shards-grid repeats (cut from 2: printed only)
TOOLS_AGG_ROUNDS = 1  # 12b: the default grid at reduced --rounds (the tool's: 3)
TOOLS_PROFILE_S = 2.5  # 12e: profile_collect --duration (cut from 5 s to keep a call under 700 s)
TOOLS_PROFILE_CHUNK = 256  # 12e: transfers a client sends a SendAssetBatch call
TOOLS_PROFILE_MAX_CHUNKS = 32  # 12e: a client's cap while the window is open
# the reference's thresholds for the plane gates (scripts/ci.sh:381-508):
# printed beside the measurement, not gated on here
OBS_BUDGET_PCT = 5.0
SHARD_SPEEDUP_MIN = 1.5
# 12d: e2e_bench's size flags: a quarter of its default 50 transfers a
# client (16 clients), the cut that pays for phase 13 (phase 6 runs the
# same nodes and gRPC ingress at full depth)
E2E_SIZE: list = ["--tx-per-client", "12"]


def zero_launch_counts() -> None:
    from at2_node_tpu_torch.ops import cuda_rlc, cuda_verify

    cuda_verify.launches = 0
    cuda_rlc.launches = cuda_rlc.fold_launches = 0
    cuda_rlc.layout_launches = [0, 0]


def launch_counts() -> Counter:
    """This process's kernel launches since :func:`zero_launch_counts`."""
    from at2_node_tpu_torch.ops import cuda_rlc, cuda_verify

    return Counter({"ed25519_verify": cuda_verify.launches, "ed25519_rlc_lanes": cuda_rlc.launches,
                    "ed25519_rlc_fold": cuda_rlc.fold_launches})


def quiet(fn, *args):
    """``fn(*args)`` with its standard output captured: (result, text)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = fn(*args)
    return result, buf.getvalue()


def write_json(path: str, doc: dict) -> None:
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")


def tools_verify(outdir: str, card: str, device: str = "cuda", k1: dict | None = None) -> dict:
    """12a: ``verify_bench`` at its three buckets; each bucket's bitmask
    must equal the plain version's on the card and the expected one (the
    tool's batches are all valid). On the card its ``roofline`` block
    (the 65,536-lane device-only rate) must score in (0, 105]%, and is
    printed beside phase 3's kernel time and bound at that bucket (``k1``,
    phase 3's row); on the host the tool writes no such block."""
    from at2_node_tpu_torch.ops import ed25519 as v
    from at2_node_tpu_torch.tools import verify_bench

    t0 = time.perf_counter()
    zero_launch_counts()
    result, bitmasks = verify_bench.run(device, verify_bench.GRID, TOOLS_TRIALS)
    launches = launch_counts()
    mismatches = 0
    for bucket in verify_bench.GRID:
        pks, msgs, sigs = verify_bench._make_batch(bucket)
        rows = v.prep_packed(pks, msgs, sigs, bucket, v.StagingPool(pinned=False))
        plain = np.unpackbits(v.verify_packed(rows.to(device)).cpu().numpy(), count=bucket).astype(bool)
        got = np.unpackbits(bitmasks[bucket], count=bucket).astype(bool)
        mismatches += int(np.count_nonzero(got != plain)) + int(np.count_nonzero(~plain))
    check(mismatches == 0, f"verify_bench (12a): kernel, plain version and expected verdicts differ on "
          f"{mismatches} lanes")
    check(launches["ed25519_verify"] > 0 or device != "cuda", "verify_bench (12a) launched no verify kernel")
    if device == "cuda":
        roof = result["roofline"]
        check(0 < roof["roofline_pct"] <= 105, f"verify_bench (12a): roofline_pct {roof['roofline_pct']} "
              f"outside (0, 105]")
        share = f"; phase 3: {k1['ms']:.3f} ms against its {k1['bound_ms']:.3f} ms bound, " \
                f"{100 * k1['bound_ms'] / k1['ms']:.1f}%" if k1 else ""
        log(f"verify_bench (12a) roofline at {result['bucket']} lanes: roofline_pct {roof['roofline_pct']}% "
            f"({roof['achieved_int32_muladd_tops']} of {roof['int32_muladd_peak_tops']} tera int32 "
            f"multiply-adds/s, {roof['chip_model']}, {roof['sm_count']} SMs; "
            f"{roof['int32_muladd_slots_per_sig']:,} slots a signature, compute/memory bound ratio "
            f"{roof['compute_vs_memory_bound_ratio']:.0f}){share}; {card}")
    else:
        check("roofline" not in result, "verify_bench (12a) wrote a roofline block on the host")
    write_json(os.path.join(outdir, "BENCH_r01.json"),
               {"cmd": "python -m at2_node_tpu_torch.tools.verify_bench", "rc": 0, "parsed": result})
    for bucket, row in result["grid"].items():
        log(f"verify_bench (12a) {bucket} lanes: device_only {row['device_only']:,.1f} sigs/s, pipelined "
            f"{row['pipelined']:,.1f} sigs/s ({row['pipelined_vs_device_pct']}%); {row['card']}")
    log(f"verify_bench (12a): {result['value']:,.1f} sigs/s at {result['bucket']} lanes, vs_baseline "
        f"{result['vs_baseline']} (BASELINE.json's 50,000); host prep {result['host_prep_rate']:,.1f}/s, "
        f"OpenSSL {result['cpu_openssl_1core_rate']:,.1f}/s a core; bitmasks equal the plain version's and "
        f"the expected ones at every bucket; {launches['ed25519_verify']} verify kernel launches; "
        f"{time.perf_counter() - t0:.1f} s")
    return {"tool": "verify_bench", "phase": "12a", "result": result, "mismatches": mismatches,
            "launches": dict(launches), "seconds": time.perf_counter() - t0}


def tools_aggregate(outdir: str, cert: dict, card: str, device: str = "cuda") -> dict:
    """12b: ``aggregate_bench --cert-route`` at n = 64 (its verdicts and
    eq_ok those of phase 3c), then the default grid at reduced rounds."""
    from at2_node_tpu_torch.tools import aggregate_bench as ab

    t0 = time.perf_counter()
    zero_launch_counts()
    routes = ab.cert_route(CERT_N, ab.ROUNDS, device)
    launches = launch_counts()
    ps, ag = routes["per_sig_kernel"], routes["rlc_aggregate"]
    j = CERT_N // 2
    check(ps["verdicts"] == {"clean": [True] * CERT_N, "tampered": [i != j for i in range(CERT_N)]},
          f"aggregate_bench (12b): the verify kernel's certificate verdicts {ps['verdicts']}")
    check(ag["verdicts"] == ag["eq_ok"] == cert["verdicts"] == {"clean": True, "tampered": False},
          f"aggregate_bench (12b): aggregate {ag['verdicts']}, eq_ok {ag['eq_ok']}, phase 3c "
          f"{cert['verdicts']}")
    check((launches["ed25519_rlc_lanes"] > 0 and launches["ed25519_rlc_fold"] > 0) or device != "cuda",
          f"aggregate_bench (12b) launched no RLC kernel: {dict(launches)}")
    log(f"aggregate_bench --cert-route (12b) n={CERT_N}: the verify kernel {ps['ms']:.3f} ms a whole "
        f"call, {ps['device_ms']:.4f} ms on the card; the RLC kernels' one equation {ag['ms']:.3f} ms, "
        f"{ag['device_ms']:.4f} ms on the card; verdicts and eq_ok {ag['verdicts']} as in phase 3c; "
        f"launches {dict(launches)}; {card}")
    t1 = time.perf_counter()
    rc, _ = quiet(ab.main, ["--rounds", str(TOOLS_AGG_ROUNDS), "--bank-dir", outdir,
                            "--label", "phase12", "--quiet", "--device", device])
    with open(os.path.join(outdir, "BENCH_AGGREGATE.json")) as f:
        summary = json.load(f)["runs"]["phase12"]["summary"]
    log(f"aggregate_bench grid (12b, host CPU, --rounds {TOOLS_AGG_ROUNDS}): rlc "
        f"{summary['rlc_sigs_per_sec']:,.1f} sigs/s, native per-signature (1 thread) "
        f"{summary['per_sig_native_1thread_sigs_per_sec']:,.1f}, python per-signature "
        f"{summary['per_sig_python_sigs_per_sec']:,.1f} at {summary['bucket']} lanes; rlc "
        f"{summary['rlc_vs_crypto_floor']}x the crypto floor (the reference's target 5x: "
        f"{'met' if summary['target_met'] else 'missed'}, exit {rc}); {time.perf_counter() - t1:.1f} s")
    return {"tool": "aggregate_bench", "phase": "12b", "cert_route": routes, "grid_summary": summary,
            "grid_rc": rc, "launches": dict(launches), "seconds": time.perf_counter() - t0}


def tools_plane(outdir: str, card: str, device: str = "cuda") -> dict:
    """12c: ``plane_bench`` with scripts/ci.sh's arguments: ``--compare-obs``,
    ``--smoke-profile`` (the loop, 2 thread and 2 process shards), and
    ``--shards-grid 1,2 --cores 2`` under each executor, every node on the
    card's verifier (the port's default). The smokes' counters are a hard
    check; the overhead and the speedup are printed beside the reference's
    thresholds."""
    from at2_node_tpu_torch.tools import plane_bench as pb

    t0 = time.perf_counter()
    zero_launch_counts()
    obs = pb.compare_obs(3, 200, device, 120.0, 0, TOOLS_PLANE_REPEAT, OBS_BUDGET_PCT, bank_dir=outdir)
    log(f"plane_bench --compare-obs (12c): obs on {obs['best_on_tx_per_sec']:,.1f} tx/s, off "
        f"{obs['best_off_tx_per_sec']:,.1f} tx/s: overhead {obs['overhead_pct']}% against the reference's "
        f"{OBS_BUDGET_PCT}% budget ({'within' if obs['ok'] else 'over'}); {obs['card']}")
    smokes = {}
    # scripts/ci.sh's two (the loop, and 2 process shards) and 2 thread shards
    for shards, executor in ((1, "thread"), (2, "thread"), (2, "process")):
        res = pb.smoke_profile(3, 200, 120.0, shards=shards, executor=executor, verifier=device)
        check(res["ok"], f"plane_bench --smoke-profile ({res['executor']}): zero phases "
              f"{res['zero_phases']}, worker-side {res['shard_zero_phases']}, folded lines "
              f"{res['folded_lines']}, worker frames {res['worker_folded_frames']}")
        smokes[res["executor"]] = res
        log(f"plane_bench --smoke-profile (12c, executor {res['executor']}, shards {shards}): every phase "
            f"counter ticked, {res['samples']} samples, {res['folded_lines']} folded lines, "
            f"{res['worker_folded_frames']} worker frames; {res['committed_tx_per_sec']:,.1f} tx/s")
    grids = {}
    for executor in ("thread", "process"):
        res = pb.shards_grid(3, 300, device, 120.0, 0, [1, 2], 2, TOOLS_PLANE_REPEAT, executor=executor,
                             bank_dir=outdir)
        grids[executor] = res["summary"]
        speedup = res["summary"]["peak_speedup_vs_1"]
        log(f"plane_bench --shards-grid 1,2 --cores 2 (12c, executor {executor}): "
            + ", ".join(f"{c['shards']} shards {c['best_tx_per_sec']:,.1f} tx/s" for c in res["grid"])
            + f"; speedup {speedup}x against the reference's {SHARD_SPEEDUP_MIN}x "
            f"({'met' if speedup >= SHARD_SPEEDUP_MIN else 'missed'}) on "
            f"{res['summary']['host_cores']} cores")
    launches = launch_counts()
    log(f"plane_bench (12c): {dict(launches)} kernel launches; {time.perf_counter() - t0:.1f} s")
    return {"tool": "plane_bench", "phase": "12c", "compare_obs": obs,
            "smoke": {k: {x: v[x] for x in ("ok", "samples", "folded_lines", "worker_folded_frames",
                                             "committed_tx_per_sec", "zero_phases")}
                      for k, v in smokes.items()},
            "shards_grid": grids, "launches": dict(launches), "seconds": time.perf_counter() - t0}


def tools_e2e(outdir: str, card: str, device: str = "cuda") -> dict:
    """12d: ``e2e_bench``'s two arms at ``E2E_SIZE`` (16 clients x 12
    transfers, unary), then ``--compose``; every transfer must commit."""
    import logging

    from at2_node_tpu_torch.tools import e2e_bench

    # loadgen's transfers go to their sender: the ledger notes each one
    logging.getLogger("at2_node_tpu_torch.ledger.accounts").setLevel(logging.ERROR)
    t0 = time.perf_counter()
    zero_launch_counts()
    rc, _ = quiet(e2e_bench.main, ["--out", os.path.join(outdir, "BENCH_E2E.json"), "--device", device,
                                   *E2E_SIZE])
    check(rc == 0, f"e2e_bench (12d) exited {rc}")
    with open(os.path.join(outdir, "BENCH_E2E.json")) as f:
        arms = json.load(f)
    for arm in ("cpu_subprocess", "cuda_inprocess"):
        a = arms[arm]
        check(a["committed"] == a["submitted"] > 0,
              f"e2e_bench (12d) {arm}: {a['committed']} of {a['submitted']} committed")
        log(f"e2e_bench (12d) {arm}: {a['committed']} of {a['submitted']} transfers committed, "
            f"{a['committed_tx_per_sec']:,.1f} tx/s ({a['topology']}); {a.get('card')}")
    t1 = time.perf_counter()
    pipeline = os.path.join(outdir, "BENCH_PIPELINE.json")
    rc, _ = quiet(e2e_bench.main, ["--compose", "--trials", str(TOOLS_COMPOSE_TRIALS), "--device", device,
                                   "--out", pipeline, "--bank-dir", outdir, *E2E_SIZE])
    check(rc == 0, f"e2e_bench --compose (12d) exited {rc}")
    with open(pipeline) as f:
        doc = json.load(f)
    composed, dec = doc["composed"], doc["decomposition"]
    check(composed["committed"] == composed["submitted"] > 0,
          f"e2e_bench --compose (12d): {composed['committed']} of {composed['submitted']} committed")
    write_json(os.path.join(outdir, "BENCH_r02.json"),
               {"cmd": "python -m at2_node_tpu_torch.tools.e2e_bench --compose", "rc": 0,
                "parsed": doc["verify_grid"]})
    ingress = doc["ingress_decomposition"]
    log(f"e2e_bench --compose (12d): verify grid {doc['verify_grid']['value']:,.1f} sigs/s pipelined; plane "
        f"{doc['plane'].get('committed_tx_per_sec')} tx/s (plane-only); ingress per-tx "
        f"{ingress.get('per_tx', {}).get('ingress_tx_per_sec')}, distilled "
        f"{ingress.get('distilled', {}).get('ingress_tx_per_sec')} tx/s; composed "
        f"{composed['committed']} of {composed['submitted']} committed, {composed['committed_tx_per_sec']:,.1f} "
        f"tx/s; binding term {dec['binding_term']}; {time.perf_counter() - t1:.1f} s; {card}")
    launches = launch_counts()
    return {"tool": "e2e_bench", "phase": "12d",
            "arms": {k: {x: arms[k][x] for x in ("submitted", "committed", "committed_tx_per_sec")}
                     for k in ("cpu_subprocess", "cuda_inprocess")},
            "compose": {"composed_tx_per_sec": composed["committed_tx_per_sec"], "decomposition": dec},
            "launches": dict(launches), "seconds": time.perf_counter() - t0}


def rebuilt_dumps(bundle_dir: str) -> dict:
    """The dumps an incident bundle directory was built from: every
    ``<node>/<surface>.json`` file, keyed as ``incident.collect`` keys them."""
    manifest = json.load(open(os.path.join(bundle_dir, "manifest.json")))
    dumps: dict = {"nodes": {}}
    for node in manifest["nodes"]:
        safe = node.replace(":", "_").replace("/", "_")
        surfaces = dumps["nodes"][node] = {}
        for name in sorted(os.listdir(os.path.join(bundle_dir, safe))):
            with open(os.path.join(bundle_dir, safe, name)) as f:
                surfaces[name[: -len(".json")]] = json.load(f)
    return dumps


async def tools_net_path(seed: int, outdir: str, card: str, device: str = "cuda") -> dict:
    """12e: four ``server run`` nodes with ``kind = "cuda"``: 16 clients
    send SendAssetBatch chunks while ``profile_collect --duration 2.5``
    profiles every node, then every transfer sent must commit on every
    node (the replay); then ``incident --now`` against the same net, its
    bundle rebuilt twice from the dumps it wrote, with its hash."""
    import copy
    import tempfile

    from at2_node_tpu_torch.client import Client
    from at2_node_tpu_torch.crypto.keys import SignKeyPair
    from at2_node_tpu_torch.tools import incident, profile_collect

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed + 12)
    clients = [SignKeyPair(rng.bytes(32)) for _ in range(NET_CLIENTS)]
    # amounts of 1, so no debit can fail however many a client sends
    n = len(clients)
    plan = [[(seq, clients[(c + 1) % n].public, 1)
             for seq in range(1, TOOLS_PROFILE_CHUNK * TOOLS_PROFILE_MAX_CHUNKS + 1)] for c in range(n)]
    with tempfile.TemporaryDirectory(prefix="at2-phase12e-") as workdir:
        net = ServerNet(device, workdir)
        try:
            start_pair([net], "profiled node net (12e)")
            addrs = [("127.0.0.1", p) for p in net.rpc_ports]
            before = [net.statusz(i) for i in range(net.n)]
            profile = asyncio.ensure_future(profile_collect.run(addrs, TOOLS_PROFILE_S))
            sent = [0] * len(clients)

            async def client(c: int) -> None:
                async with Client(f"http://127.0.0.1:{net.rpc_ports[c % net.n]}") as conn:
                    while sent[c] == 0 or not profile.done():
                        check(sent[c] < len(plan[c]), f"12e: client {c} ran out of transfers")
                        chunk = plan[c][sent[c]:sent[c] + TOOLS_PROFILE_CHUNK]
                        await conn.send_asset_many(clients[c], chunk)
                        sent[c] += len(chunk)

            t_load = time.perf_counter()
            await asyncio.gather(*(client(c) for c in range(len(clients))))
            results = await profile
            total = sum(sent)
            wait_committed(net, [b["stats"]["committed"] + total for b in before], NET_DEADLINE_S)
            log(f"profiled node net (12e): {total} transfers from {len(clients)} clients committed on all "
                f"{net.n} nodes, {total / (time.perf_counter() - t_load):,.0f} tx/s while profile_collect "
                f"--duration {TOOLS_PROFILE_S:g} ran")
            await check_replay(net, clients, [plan[c][:sent[c]] for c in range(len(clients))])
            down = [a for a, r in results if isinstance(r, Exception)]
            check(not down, f"profile_collect (12e): nodes {down} failed: {results}")
            check(all(r["capture_started"] and r["plane_total_ms"] > 0 for _, r in results),
                  "profile_collect (12e): a node's capture did not start or its plane spent no time")
            import io

            report = io.StringIO()
            profile_collect.render(results, TOOLS_PROFILE_S, 0.0, report)
            log(report.getvalue().rstrip())
            launches = sum(net.statusz(i)["build"]["kernel_launches"] - before[i]["build"]["kernel_launches"]
                           for i in range(net.n))
            check(launches > 0 or device != "cuda", "12e: the servers launched no verify kernel")
            # incident --now as an operator runs it, then the bundle rebuilt
            # twice from the dumps it wrote
            root = os.path.join(outdir, "incidents")
            proc = subprocess.run(
                [sys.executable, "-m", "at2_node_tpu_torch.tools.incident", "--now",
                 *(f"{h}:{p}" for h, p in addrs), "--out", root],
                capture_output=True, text=True, env=checkout_env(), timeout=120)
            check(proc.returncode == 0, f"incident --now exited {proc.returncode}: {proc.stderr[-2000:]}")
            manifest = json.loads(proc.stdout)
            bundle_dir = os.path.join(root, [d for d in os.listdir(root)
                                             if d.endswith(manifest["bundle_sha256"][:8])][0])
            dumps = rebuilt_dumps(bundle_dir)
            b1 = incident.build_bundle(dumps, reason=manifest["reason"])
            b2 = incident.build_bundle(copy.deepcopy(dumps), reason=manifest["reason"])
            check(b1["files"] == b2["files"]
                  and b1["manifest"] == b2["manifest"] == manifest,
                  "incident (12e): the bundle rebuilt from its dumps differs from the one written")
            log(f"incident --now (12e): {len(manifest['files'])} files from {len(manifest['nodes'])} nodes, "
                f"bundle {manifest['bundle_sha256'][:16]}..., rebuilt twice from its dumps with the same "
                f"hash; {card}")
        finally:
            rcs = net.stop()
        check(rcs == [0] * net.n, f"12e: servers exited with {rcs} on SIGTERM")
    profiles = {a: {"coverage": r["coverage"], "top_serial": r["top_serial"], "plane_total_ms": r["plane_total_ms"],
                    "shares": r["shares"], "off_plane_ms": r["off_plane_ms"]} for a, r in results}
    return {"tool": "profile_collect", "phase": "12e", "profiles": profiles, "transfers": total,
            "incident": {"files": len(manifest["files"]), "bundle_sha256": manifest["bundle_sha256"]},
            "launches": {"ed25519_verify": launches}, "seconds": time.perf_counter() - t0}


def tools_durability(outdir: str, card: str, device: str = "cuda") -> dict:
    """12f: ``bench_durability`` at the reference's defaults, the restarted
    node on the card's verifier."""
    from at2_node_tpu_torch.tools import bench_durability

    t0 = time.perf_counter()
    zero_launch_counts()
    path = os.path.join(outdir, "BENCH_DURABILITY.json")
    rc, _ = quiet(bench_durability.main, ["--out", path, "--verifier", device])
    with open(path) as f:
        doc = json.load(f)
    check(rc == 0 and doc["ok"], f"bench_durability (12f) exited {rc}: ok {doc['ok']}")
    launches = launch_counts()
    inc = doc["incremental_flush"]
    log(f"bench_durability (12f): {doc['accounts']:,} accounts in {doc['shards']} shards migrated in "
        f"{doc['migrate_s']} s; full flush {doc['full_flush']['bytes']:,} bytes in {doc['full_flush']['wall_s']} s; "
        + ", ".join(f"delta {r['delta_commits']}: {r['segments_written']} segments, {r['bytes_vs_full']} of "
                    f"full" for r in inc)
        + f"; store open {doc['store_open']['wall_s']} s; the node healthy after "
        f"{doc['service_restart']['healthy_after_s']} s ({doc['service_restart']['status']}, "
        f"{doc['service_restart']['catchup_transfers']} catch-up transfers); {time.perf_counter() - t0:.1f} s; "
        f"{doc['card']}")
    return {"tool": "bench_durability", "phase": "12f", "ok": doc["ok"], "migrate_s": doc["migrate_s"],
            "healthy_after_s": doc["service_restart"]["healthy_after_s"],
            "incremental_flush": inc, "launches": dict(launches), "seconds": time.perf_counter() - t0}


def tools_regress(outdir: str) -> dict:
    """12g: the port's ``regress --dir`` over what phase 12 wrote: every file
    must load (exit 2 is a schema error), and a regression is printed."""
    from at2_node_tpu_torch.tools import regress

    rc, report = quiet(regress.main, ["--dir", outdir])
    check(rc in (0, 1), f"regress (12g) exited {rc} over {sorted(os.listdir(outdir))}")
    log(report.rstrip())
    return {"tool": "regress", "phase": "12g", "rc": rc,
            "files": sorted(f for f in os.listdir(outdir) if f.endswith(".json")),
            "regressions": report.rstrip().splitlines()[-1]}


def tools_path(seed: int, cert: dict, card: str, device: str = "cuda", k1: dict | None = None) -> tuple:
    """Phase 12: the port's measurement tools on the card (``device``
    "cpu" rehearses it on the host), every row into a temporary
    directory; returns (one JSON line's object a tool, the kernel
    launches summed over the phase)."""
    import tempfile

    t12 = time.perf_counter()
    rows, seconds = [], []
    with tempfile.TemporaryDirectory(prefix="at2-phase12-") as outdir:
        for step in (lambda: tools_verify(outdir, card, device, k1), lambda: tools_aggregate(outdir, cert, card, device),
                     lambda: tools_plane(outdir, card, device), lambda: tools_e2e(outdir, card, device),
                     lambda: asyncio.run(tools_net_path(seed, outdir, card, device)),
                     lambda: tools_durability(outdir, card, device), lambda: tools_regress(outdir)):
            t = time.perf_counter()
            rows.append(step())
            seconds.append(round(time.perf_counter() - t, 1))
    totals = Counter()
    for row in rows:
        totals.update(row.get("launches", {}))
    log(f"phase 12 (the measurement tools) took {time.perf_counter() - t12:.1f} s (12a-12g: {seconds} s); "
        f"kernel launches {dict(totals)}; {card}")
    return rows, totals


# -- phase 13 --------------------------------------------------------------


OVERLOAD_STEADY = 40  # registered clients, one unary SendAsset each every STEADY_PERIOD_S
OVERLOAD_CROWD = 80  # fresh clients: the reference A/B's 120/80 split (sim/scenarios.py)
OVERLOAD_CROWD_PER = 128  # transfers a crowd client (a depth that leaves time for phase 14)
OVERLOAD_CHUNK = 64  # transfers a crowd client's SendAssetBatch call
OVERLOAD_RETRY_BUDGET = 8  # RetryPolicy(budget) of every client
STEADY_PERIOD_S = 0.1  # 40 clients: 400 tx/s
CROWD_AT_S = 3.0  # the crowd starts this long into the arm
STEADY_TAIL_S = 10.0  # the steady tier runs on at least this long after the crowd's end
LEVEL0_WITHIN_S = 15.0  # arm on: every node back at level 0 this soon after the crowd's end
HEALTH_POLL_S = 0.2  # /healthz of every node at 5 Hz (the check: 4 Hz or faster)
PRESSURE_POLL_S = 0.5  # the /statusz pressure block of every node
# [observability] trace_cap and trace_done_cap on every node of both arms:
# every transfer of an arm stays on /tracez, where the steady tier's
# commit stamps are read
TRACE_CAP = 65536
PROFILED_NODE = 3  # the node with [observability] profile_dir
K1_SYMBOL = "ed25519_verify_kernel"


def counted_retry(seed: int, retried: list):
    """``RetryPolicy(budget=OVERLOAD_RETRY_BUDGET)`` with a seeded jitter
    that appends ``(time.monotonic(), hint_ms)`` to ``retried`` at every
    refusal it retries (the policy retries RESOURCE_EXHAUSTED only; the
    refusal that spends the budget reaches the caller)."""
    import random

    from at2_node_tpu_torch.client import RetryPolicy

    class Counted(RetryPolicy):
        def delay_s(self, attempt: int, hint_ms=None) -> float:
            retried.append((time.monotonic(), hint_ms))
            return super().delay_s(attempt, hint_ms)

    return Counted(budget=OVERLOAD_RETRY_BUDGET, rng=random.Random(seed).random)


def slo_breach(h: tuple) -> bool:
    """A ``Poller`` /healthz reading answered 503 ``degraded`` for SLO
    breaches alone (never a stall, a lost quorum, a divergence or a dead
    worker)."""
    why = h[5].split("+")
    return h[1] == 503 and why[0] == "degraded" and len(why) > 1 and all(r.startswith("slo:") for r in why[1:])


def health_reason(body: dict) -> str:
    """Why a /healthz verdict is not ``ok``: its status and the fields
    that decided it."""
    why = [k for k in ("stalled", "closing", "recovering") if body.get(k)]
    why += [f"slo:{name}" for name in body.get("slo_breach") or ()]
    why += [] if body.get("quorum_ok", True) else ["quorum_lost"]
    return "+".join([str(body.get("status"))] + why)


def poller_main(conn, ports: list, levels) -> None:
    """A ``Poller``'s process: threads that GET ``/healthz`` of every node
    (``ports``: their RPC ports) every HEALTH_POLL_S and its ``/statusz``
    pressure block every PRESSURE_POLL_S, each reading stamped with
    ``time.monotonic()`` (system-wide) at its start. A ``/healthz`` GET is
    issued on the clock whether or not the one before it has answered (a
    pool runs them). ``levels[i]`` holds node i's level at the reading
    that started last. Answers ``("ready",)`` once polling, and at
    ``("stop",)`` stops and sends (health readings, pressure readings)."""
    import threading
    import urllib.error
    import urllib.request

    n = len(ports)
    stop = threading.Event()
    lock = threading.Lock()
    pool = ThreadPoolExecutor(max_workers=16 * n)
    health: list = [[] for _ in range(n)]
    pressure: list = [[] for _ in range(n)]
    newest = [0.0] * n

    def get(i: int, path: str, timeout: float):
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{ports[i]}{path}", timeout=timeout) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as exc:
            return exc.code, json.loads(exc.read() or b"{}")

    def health_once(i: int) -> None:
        t = time.monotonic()
        try:
            code, body = get(i, "/healthz", 5)
        except OSError:
            code, body = None, {}
        reading = (t, code, body.get("status"), body.get("overload_level"), body.get("pressure"),
                   health_reason(body), time.monotonic() - t)
        with lock:
            health[i].append(reading)
            if code is not None and t >= newest[i]:
                newest[i] = t
                levels[i] = body.get("overload_level") or 0

    def health_loop(i: int) -> None:
        while not stop.is_set():
            t = time.monotonic()
            pool.submit(health_once, i)
            stop.wait(max(0.0, t + HEALTH_POLL_S - time.monotonic()))

    def pressure_loop(i: int) -> None:
        while not stop.is_set():
            t = time.monotonic()
            try:
                pressure[i].append((t, get(i, "/statusz", 30)[1]["pressure"]))
            except (OSError, KeyError):
                pass
            stop.wait(max(0.0, t + PRESSURE_POLL_S - time.monotonic()))

    threads = [threading.Thread(target=fn, args=(i,), daemon=True)
               for i in range(n) for fn in (health_loop, pressure_loop)]
    for t in threads:
        t.start()
    conn.send(("ready",))
    conn.recv()
    stop.set()
    for t in threads:
        t.join(timeout=10)
    pool.shutdown(wait=True)
    conn.send((health, pressure))


class Poller:
    """``poller_main`` in a spawned process of its own, so that the
    driver's own load (its clients, the trace parsing, its GIL) cannot set
    the poll rate. Readings of ``/healthz``: (start, HTTP status or None
    on no answer in 5 s, status, level, pressure, reason, seconds to the
    answer); ``pressure[i]`` holds (start, the pressure block). Readings
    are there once the poller has stopped; ``level`` reads the live one."""

    def __init__(self, net: ServerNet) -> None:
        self.net = net
        self._health_readings: list = [[] for _ in range(net.n)]
        self.pressure: list = [[] for _ in range(net.n)]

    def __enter__(self) -> "Poller":
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        self.levels = ctx.Array("i", self.net.n, lock=False)
        self.conn, theirs = ctx.Pipe()
        self.proc = ctx.Process(target=poller_main, args=(theirs, list(self.net.rpc_ports), self.levels),
                                daemon=True)
        self.proc.start()
        theirs.close()
        check(self.conn.poll(60) and self.conn.recv() == ("ready",), "the poller process did not start")
        return self

    def __exit__(self, *exc) -> None:
        try:
            self.conn.send(("stop",))
            check(self.conn.poll(60), "the poller process sent no readings")
            self._health_readings, self.pressure = self.conn.recv()
        finally:
            self.proc.join(timeout=10)
            if self.proc.is_alive():
                self.proc.kill()
                self.proc.join()

    def health(self, i: int) -> list:
        """Node i's /healthz readings in the order their GETs started."""
        return sorted(self._health_readings[i], key=lambda h: h[0])

    def level(self, i: int) -> int:
        """Node i's level at its newest /healthz reading."""
        return self.levels[i]


def drop_counters(metrics: dict) -> dict:
    """The /metrics samples whose name counts dropped work."""
    return {k: v for k, v in metrics.items() if "drop" in k}


def rate_text(r) -> str:
    """A rate in tx/s; None: no window to take it over."""
    return "n/a" if r is None else f"{r:,.1f} tx/s"


def seconds_or_never(s) -> str:
    """A reading of seconds after the crowd's end; None: not within the arm."""
    return "not within the arm" if s is None else f"{s:.2f} s"


def dominant_signal(blocks: list) -> tuple:
    """From a node's /statusz pressure blocks: the signal that was largest
    at its peak pressure, and how many readings each signal led (readings
    with every signal at 0 lead none)."""
    led = Counter()
    for _, b in blocks:
        sig = b.get("signals") or {}
        if sig and max(sig.values()) > 0:
            led[max(sig, key=sig.get)] += 1
    peak = max(blocks, key=lambda tb: tb[1].get("pressure", 0.0), default=(0, {}))[1]
    sig = peak.get("signals") or {}
    top = max(sig, key=sig.get) if sig and max(sig.values()) > 0 else None
    return top, dict(led)


def drained_after(blocks: list, t_from: float, elevated: float) -> tuple:
    """From a node's /statusz pressure blocks: the seconds after
    ``t_from`` until every signal but ``burn`` stayed below ``elevated``
    to the last reading (inf if the last reading is above it), and
    whether the controller took a sample after ``t_from``."""
    after = [(t, b) for t, b in blocks if t >= t_from]
    if not after:
        return float("inf"), False
    high = [k for k, (_, b) in enumerate(after)
            if any(v >= elevated for name, v in (b.get("signals") or {}).items() if name != "burn")]
    drained = (0.0 if not high else after[high[-1] + 1][0] - t_from if high[-1] + 1 < len(after)
               else float("inf"))
    return drained, after[-1][1].get("samples", 0) > after[0][1].get("samples", 0)


def trace_kernels(path: str) -> dict:
    """A ``torch.profiler`` Chrome trace: its K1 kernel events and their
    summed duration, every device event's busy union, and the trace's
    window (first event's start to last event's end), in ms."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X" and "ts" in e]
    device = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                    for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    k1 = [e for e in events if e.get("cat") == "kernel" and K1_SYMBOL in e.get("name", "")]
    busy, end = 0.0, None
    for a, b in device:  # the union of the device's intervals
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    t0 = min((float(e["ts"]) for e in events), default=0.0)
    t1 = max((float(e["ts"]) + float(e.get("dur", 0)) for e in events), default=0.0)
    return {"k1_events": len(k1), "k1_ms": sum(float(e.get("dur", 0)) for e in k1) / 1e3,
            "device_busy_ms": busy / 1e3, "window_ms": (t1 - t0) / 1e3, "events": len(events)}


def overload_plan(seed: int, n_steady: int, n_crowd: int, crowd_per: int, chunk: int) -> dict:
    """Both arms' keys and the crowd's requests, signed before either arm
    (the crowd's clients then start together)."""
    from at2_node_tpu_torch.crypto.keys import SignKeyPair
    from at2_node_tpu_torch.proto import at2_pb2 as pb
    from at2_node_tpu_torch.types import transfer_signing_bytes

    rng = np.random.default_rng(seed + 13)
    steady = [SignKeyPair(rng.bytes(32)) for _ in range(n_steady)]
    crowd = [SignKeyPair(rng.bytes(32)) for _ in range(n_crowd)]
    chunks = []
    for kp in crowd:
        reqs = [pb.SendAssetRequest(sender=kp.public, sequence=s, recipient=kp.public, amount=1,
                                    signature=kp.sign(transfer_signing_bytes(kp.public, s, kp.public, 1)))
                for s in range(1, crowd_per + 1)]
        chunks.append([pb.SendAssetBatchRequest(transactions=reqs[lo:lo + chunk])
                       for lo in range(0, crowd_per, chunk)])
    return {"seed": seed, "steady": steady, "crowd": crowd, "crowd_per": crowd_per, "chunk": chunk,
            "seeds": [(steady[(c + 1) % n_steady].public, int(rng.integers(1, 51))) for c in range(n_steady)],
            "chunks": chunks}


def overload_net(on: bool, kind: str, workdir: str) -> ServerNet:
    """An arm's four ``server run`` nodes: every node with the trace caps,
    node PROFILED_NODE with ``profile_dir``, arm on with ``[overload]
    enabled = true`` (every other key at the reference's default)."""
    os.makedirs(workdir)

    def tables(i: int) -> str:
        text = (f"[observability]\ntrace_cap = {TRACE_CAP}\ntrace_done_cap = {TRACE_CAP}\n"
                + (f'profile_dir = "{os.path.join(workdir, "profile")}"\n' if i == PROFILED_NODE else ""))
        return text + ("\n[overload]\nenabled = true\n" if on else "")

    return ServerNet(kind, workdir, tables=tables)


async def register_keys(net: ServerNet, clients: list, keys: list, numbers=None) -> int:
    """Each key is registered through node c mod n, c its number
    (``numbers[k]``, by default k; ``clients[i]`` talks to node i); then
    every node's ``directory_size`` must count them all and a ``Register``
    of each key at every node must answer the id it was given (a node
    that did not know a key would assign a new one). The directory size
    every node reached."""
    n = net.n
    numbers = range(len(keys)) if numbers is None else numbers
    ids = await asyncio.gather(*(clients[c % n].register(kp.public) for c, kp in zip(numbers, keys)))
    t_end = time.perf_counter() + 30.0
    while True:
        sizes = [int(net.metrics(i)["at2_directory_size"]) for i in range(n)]
        if sizes == [len(keys)] * n:
            break
        check(time.perf_counter() < t_end, f"directory sizes {sizes}, not {len(keys)} on every node")
        time.sleep(0.1)
    for i in range(n):
        again = await asyncio.gather(*(clients[i].register(kp.public) for kp in keys))
        check(list(again) == list(ids), f"node {i}'s directory lacks registered clients")
    return sizes[0]


async def register_steady(net: ServerNet, clients: list, keys: list, seeds: list,
                          label: str = "overload node net") -> None:
    """The steady tier joins before the crowd: ``register_keys``, then
    each key commits one transfer (``seeds[c]``, sequence 1) on every
    node."""
    n = net.n
    size = await register_keys(net, clients, keys)
    before = [net.committed(i) for i in range(n)]
    await asyncio.gather(*(clients[c % n].send_asset(kp, 1, *seeds[c]) for c, kp in enumerate(keys)))
    wait_committed(net, [b + len(keys) for b in before], 60.0)
    log(f"{label}: {len(keys)} steady clients registered (through node c mod {n}) and one "
        f"transfer each committed on all {n} nodes; directory_size {size} on every node, and Register "
        f"of each key at every node answered the id it was given")


async def overload_drive(net: ServerNet, on: bool, plan: dict, tail_s: float) -> dict:
    """An arm's traffic on its started net: the steady tier registers,
    then sends a unary ``SendAsset`` a client every STEADY_PERIOD_S,
    round-robin over the nodes, until ``tail_s`` after the crowd's end (in
    arm on, until every node is back at level 0, at most LEVEL0_WITHIN_S
    and one poll); CROWD_AT_S in, the crowd sends its chunks, chunk k of client
    c to node (c + k) mod n, each through a RetryPolicy of budget 8, a
    chunk only once the one before it was acknowledged (a client whose
    budget runs out stops: its rest is refused, never a gap). Returns once
    every node has committed every acknowledged transfer."""
    import grpc

    from at2_node_tpu_torch.client import Client
    from at2_node_tpu_torch.node.overload import parse_retry_after_ms
    from at2_node_tpu_torch.proto.rpc import At2Stub

    n, seed, steady_keys = net.n, plan["seed"], plan["steady"]
    n_steady, n_crowd, crowd_per = len(steady_keys), len(plan["crowd"]), plan["crowd_per"]
    run = {"status0": [net.statusz(i) for i in range(n)], "drops0": [drop_counters(net.metrics(i)) for i in range(n)],
           "steady_retried": [], "steady_acks": [[] for _ in range(n_steady)], "crowd_acked": [0] * n_crowd,
           "crowd_retried": [0] * n_crowd, "crowd_refused": [0] * n_crowd,
           "crowd_retried_at": [[] for _ in range(n_crowd)], "crowd_times": [], "refusals": []}
    urls = [f"http://127.0.0.1:{p}" for p in net.rpc_ports]
    clients = [Client(u, retry=counted_retry(seed * 100 + i, run["steady_retried"])) for i, u in enumerate(urls)]
    channels = [grpc.aio.insecure_channel(u[len("http://"):]) for u in urls]
    stubs = [At2Stub(ch) for ch in channels]
    stop = asyncio.Event()

    async def steady(c: int, t0: float) -> None:
        kp, srng, acks = steady_keys[c], np.random.default_rng([seed, 13, c]), run["steady_acks"][c]
        seq, k = 2, 0
        while True:
            # tick k of client c; ticks missed while a call retried are skipped
            await asyncio.sleep(max(0.0, t0 + (k + c / n_steady) * STEADY_PERIOD_S - time.monotonic()))
            if stop.is_set():
                return
            recipient = steady_keys[(c + 1 + int(srng.integers(0, n_steady - 1))) % n_steady].public
            amount = int(srng.integers(1, 51))
            try:
                await clients[(c + k) % n].send_asset(kp, seq, recipient, amount)
            except grpc.aio.AioRpcError as exc:
                run["refusals"].append(("steady", time.monotonic(), exc.code(), parse_retry_after_ms(exc.details())))
                return
            acks.append((seq, recipient, amount, time.monotonic()))
            seq += 1
            k = max(k + 1, int((time.monotonic() - t0) / STEADY_PERIOD_S - c / n_steady) + 1)

    async def crowd(c: int, t_go: float) -> None:
        retried_at = run["crowd_retried_at"][c]
        policy = counted_retry(seed * 1000 + c, retried_at)
        await asyncio.sleep(max(0.0, t_go - time.monotonic()))
        t_begin = time.monotonic()
        for k, req in enumerate(plan["chunks"][c]):
            before = len(retried_at)
            try:
                await policy.run(lambda stub=stubs[(c + k) % n], req=req: stub.SendAssetBatch(req))
            except grpc.aio.AioRpcError as exc:
                run["refusals"].append(("crowd", time.monotonic(), exc.code(), parse_retry_after_ms(exc.details())))
                run["crowd_refused"][c] = crowd_per - run["crowd_acked"][c]
                break
            finally:
                run["crowd_retried"][c] += (len(retried_at) - before) * len(req.transactions)
            run["crowd_acked"][c] += len(req.transactions)
        run["crowd_times"].append((t_begin, time.monotonic()))

    try:
        await register_steady(net, clients, steady_keys, plan["seeds"])
        committed0 = [net.committed(i) for i in range(n)]
        with Poller(net) as poll:
            t0 = time.monotonic()
            t_crowd = t0 + CROWD_AT_S
            steady_tasks = [asyncio.create_task(steady(c, t0)) for c in range(n_steady)]
            await asyncio.gather(*(crowd(c, t_crowd) for c in range(n_crowd)))
            t_crowd_end = max(e for _, e in run["crowd_times"])
            await asyncio.sleep(max(0.0, t_crowd_end + tail_s - time.monotonic()))
            while on and any(poll.level(i) for i in range(n)) and \
                    time.monotonic() < t_crowd_end + LEVEL0_WITHIN_S + HEALTH_POLL_S:
                await asyncio.sleep(HEALTH_POLL_S)
            stop.set()
            await asyncio.gather(*steady_tasks)
            t_stop = time.monotonic()
            # check 1: every acknowledged transfer commits on every node
            acked = sum(len(a) for a in run["steady_acks"]) + sum(run["crowd_acked"])
            wait_committed(net, [c0 + acked for c0 in committed0], 120.0)
            t_end = time.perf_counter() + 30.0
            while any(net.stats(i)["slots_undelivered"] for i in range(n)):
                check(time.perf_counter() < t_end, "overload node net: slots still undelivered")
                time.sleep(0.1)
            t_poll_end = time.monotonic()
    finally:
        for cl in clients:
            await cl.close()
        for ch in channels:
            await ch.close()
    run.update(poll=poll, t0=t0, t_crowd=t_crowd, t_crowd_end=t_crowd_end, t_stop=t_stop, t_poll_end=t_poll_end)
    return run


async def overload_collect(net: ServerNet, run: dict, plan: dict, label: str) -> None:
    """Right after an arm's traffic, its net still up: the ledgers against
    the replay, each steady sender's sequences, every node's ``/statusz``
    and ``/metrics``, and from every node's ``/tracez`` the steady tier's
    latencies (``steady_latencies``), kept in ``run``. The traces
    themselves are dropped here: held through the next arm, their
    hundred thousand records would slow that arm's event loop."""
    n, steady_keys, crowd_keys = net.n, plan["steady"], plan["crowd"]
    steady_acks, crowd_acked = run["steady_acks"], run["crowd_acked"]
    per_client = [[(1, *plan["seeds"][c])] + [(s, r, a) for s, r, a, _ in steady_acks[c]]
                  for c in range(len(steady_keys))]
    per_client += [[(s, kp.public, 1) for s in range(1, crowd_acked[c] + 1)] for c, kp in enumerate(crowd_keys)]
    await check_replay(net, steady_keys + crowd_keys, per_client)
    for c, acks in enumerate(steady_acks):  # each steady sender's acknowledged sequences: 2, 3, ... in order
        check([s for s, *_ in acks] == list(range(2, 2 + len(acks))),
              f"{label}: steady client {c}'s sequences are not contiguous")
    with ThreadPoolExecutor(max_workers=n) as pool:
        run["status"] = list(pool.map(net.statusz, range(n)))
        run["metrics"] = list(pool.map(net.metrics, range(n)))
        traces = list(pool.map(lambda i: json.loads(net.get(i, f"/tracez?limit={TRACE_CAP}")), range(n)))
    run["steady_latencies"] = lats, stamped_on, short = steady_latencies(traces, steady_keys, steady_acks)
    # what each node's /tracez holds of the first few transfers stamped on fewer than n
    run["short_records"] = {f"{k[0][:12]}/{k[1]}": [[(r["terminal"], [st for st, _, _ in r["stages"]])
                                                     for r in d["completed"] + d["live"] if (r["sender"], r["seq"]) == k]
                                                    for d in traces] for k in short[:3]}
    run["trace_sizes"] = [len(d["completed"]) + len(d["live"]) for d in traces]


def steady_latencies(traces: list, steady_keys: list, steady_acks: list) -> tuple:
    """Each acknowledged steady transfer's seconds from its acknowledgement
    to the latest of its commit stamps, taken only from transfers whose
    ``committed`` stamp is on every node's ``/tracez``; how many transfers
    were stamped on how many nodes; and the keys of those stamped on fewer."""
    commit_at: dict = {}  # (sender hex, seq) -> {node: its commit stamp}
    for i, dump in enumerate(traces):
        for rec in dump["completed"] + dump["live"]:
            for stage, mono, _ in rec["stages"]:
                if stage == "committed":
                    commit_at.setdefault((rec["sender"], rec["seq"]), {})[i] = mono
    lats, stamped_on, short = [], Counter(), []
    for c, acks in enumerate(steady_acks):
        for seq, _, _, t_ack in acks:
            key = (steady_keys[c].public.hex(), seq)
            stamps = commit_at.get(key, {})
            stamped_on[len(stamps)] += 1
            if len(stamps) == len(traces):
                lats.append(max(stamps.values()) - t_ack)
            else:
                short.append(key)
    return lats, dict(stamped_on), short


def overload_readings(net: ServerNet, run: dict, on: bool, plan: dict, by_lanes, card, kind: str,
                      failures: list) -> dict:
    """An arm's readings once its net has stopped: what ``overload_collect``
    kept, the pressure readings and node PROFILED_NODE's trace; the arm's
    readings are printed, and the checks that fail are appended to
    ``failures`` (the phase fails on them once both arms have printed
    theirs). The strict forms of checks 6 and 7 (``/healthz`` 200
    ok/overloaded at every poll; every node back at level 0 within
    LEVEL0_WITHIN_S of the crowd's end) are known to miss on the card
    (ROADMAP section 3): each is printed as held or missed, never gated,
    and kept in the arm's readings."""
    import grpc

    from at2_node_tpu_torch.node.config import OverloadConfig
    from at2_node_tpu_torch.node.overload import ELEVATED_FRAC
    from at2_node_tpu_torch.sim.scenarios import jain_index

    arm = "on" if on else "off"
    label = f"overload node net (13, arm {arm})"
    ov = OverloadConfig()  # the reference's defaults: arm on's table sets only enabled
    n, steady_keys, crowd_keys = net.n, plan["steady"], plan["crowd"]
    poll, t0, t_crowd, t_crowd_end = run["poll"], run["t0"], run["t_crowd"], run["t_crowd_end"]
    steady_acks, crowd_acked = run["steady_acks"], run["crowd_acked"]
    status, metrics = run["status"], run["metrics"]

    def gate(cond: bool, what: str) -> None:
        if not cond:
            failures.append(f"{label}: {what}")

    trace_path = os.path.join(net.workdir, "profile", f"at2-node-{net.procs[PROFILED_NODE].pid}.trace.json")
    check(os.path.exists(trace_path), f"{label}: node {PROFILED_NODE} wrote no trace {trace_path}")
    trace = trace_kernels(trace_path)

    lats, stamped_on, short = run["steady_latencies"]
    n_steady_acked = sum(len(a) for a in steady_acks)
    partly = len(short)
    # check 1's commits as the nodes traced them: every acknowledged steady
    # transfer carries a committed stamp on every node's /tracez
    if partly:  # what each node's /tracez and trace counters hold of the first few
        counters = [{k: v for k, v in m.items() if k.startswith("at2_tx_trace")} for m in metrics]
        log(f"{label}: {partly} of {n_steady_acked} steady transfers (committed on every node: check 1) lack a "
            f"commit stamp on some node's /tracez and are left out of the latency (transfers by the number of "
            f"nodes that stamped them: {stamped_on}); e.g. records {run['short_records']}; /tracez sizes "
            f"{run['trace_sizes']}; trace counters {counters}")
    gate(not partly and bool(lats), f"{partly} of {n_steady_acked} steady transfers lack a commit stamp on some "
         f"node's /tracez")
    p50, p99 = (float(np.percentile(lats, q)) * 1e3 if lats else float("nan") for q in (50, 99))
    refusals, steady_retried = run["refusals"], run["steady_retried"]
    retried = [h for rs in run["crowd_retried_at"] for _, h in rs] + [h for _, h in steady_retried]
    shed_times = [t for rs in run["crowd_retried_at"] for t, _ in rs] + [t for t, _ in steady_retried] \
        + [t for _, t, _, _ in refusals]
    starts = [s for s, _ in run["crowd_times"]]
    out = {
        "arm": arm, "steady_p50_ms": p50, "steady_p99_ms": p99,
        "steady_tx_per_s": n_steady_acked / (run["t_stop"] - t0), "steady_committed": n_steady_acked,
        "steady_stamped_on": stamped_on, "steady_partly_stamped": partly,
        "steady_shed": len(steady_retried) + sum(1 for r in refusals if r[0] == "steady"),
        "jain": jain_index([float(len(a)) for a in steady_acks]),
        "crowd_committed": sum(crowd_acked), "crowd_retried": sum(run["crowd_retried"]),
        "crowd_refused": sum(run["crowd_refused"]), "crowd_start_spread_s": max(starts) - min(starts),
        "crowd_s": t_crowd_end - t_crowd, "sheds_before_crowd": sum(1 for t in shed_times if t < t_crowd),
        "refusals": len(refusals) + len(retried), "arm_s": run["t_stop"] - t0,
    }

    # checks 2-8, a node's readings
    if on:
        # check 2 holds over the refusals seen; with none seen it holds
        # vacuously, and the shed path did not run (printed below)
        gate(all(code == grpc.StatusCode.RESOURCE_EXHAUSTED for _, _, code, _ in refusals),
             f"refusals not RESOURCE_EXHAUSTED: {sorted({str(r[2]) for r in refusals})}")
        hints = retried + [h for *_, h in refusals]
        gate(all(h is not None and ov.retry_after_ms <= h <= ov.retry_after_max_ms for h in hints),
             f"a refusal's retry_after_ms outside [{ov.retry_after_ms}, {ov.retry_after_max_ms}]: "
             f"{sorted({h for h in hints if h is None or not ov.retry_after_ms <= h <= ov.retry_after_max_ms}, key=str)[:8]}")
    else:
        gate(not refusals and not retried, f"{len(refusals) + len(retried)} refusals without an [overload] table")
    nodes = []
    t_poll_end = run["t_poll_end"]
    for i in range(n):
        st, m, b0 = status[i]["stats"], metrics[i], run["status0"][i]["build"]
        health = [h for h in poll.health(i) if t0 <= h[0] <= t_poll_end]
        shed_req, shed_ent = int(m["at2_overload_shed_requests_total"]), int(m["at2_overload_shed_entries_total"])
        if not on:
            gate(shed_req == shed_ent == 0, f"node {i}: {shed_req} overload sheds")
            gate(all(h[3] == 0 and h[4] == 0 for h in poll.health(i) if h[1] is not None)
                 and status[i]["pressure"]["pressure"] == 0 and status[i]["pressure"]["level"] == "normal",
                 f"node {i}: the controller moved without an [overload] table")
        gate(m["at2_admission_throttled_total"] == 0 and m["at2_rejected_at_ingress_total"] == 0,
             f"node {i}: admission_throttled {m['at2_admission_throttled_total']}, "
             f"rejected_at_ingress {m['at2_rejected_at_ingress_total']}")
        drops = drop_counters(m)
        gate(drops == run["drops0"][i], f"node {i}: drop counters moved: {run['drops0'][i]} -> {drops}")
        gate(st["slots_undelivered"] == 0, f"node {i}: slots_undelivered {st['slots_undelivered']}")
        # check 6, gated: every poll answered, at 4 Hz or faster; a 503 only
        # for an SLO breach (the node's [slo] commit_latency_p99 burning in
        # both windows), never for a stall, a lost quorum, a divergence or
        # a dead worker. The strict form (200 ok/overloaded at every poll)
        # is a known miss: printed
        not_ok = [h for h in health if h[1] != 200 or h[2] not in ("ok", "overloaded")]
        slo_only = [h for h in not_ok if slo_breach(h)]
        gate(len(slo_only) == len(not_ok), f"node {i}: /healthz answered {len(not_ok) - len(slo_only)} of "
             f"{len(health)} polls otherwise than 200 ok/overloaded or 503 for an SLO breach: "
             f"{dict(Counter((h[1], h[5]) for h in not_ok if h not in slo_only))}")
        rate = len(health) / (t_poll_end - t0)
        gate(rate >= 4.0, f"node {i}: /healthz polled at {rate:.2f} Hz")
        gaps = [b[0] - a[0] for a, b in zip(health, health[1:])]
        after = [h for h in poll.health(i) if h[0] >= t_crowd_end]
        high = [k for k, h in enumerate(after) if h[3]]
        # the first level-0 reading after the last one above it: the
        # strict check 7 (a known miss on the card: printed)
        back_s = (0.0 if not high else after[high[-1] + 1][0] - t_crowd_end if high[-1] + 1 < len(after)
                  else float("inf"))
        # gated in arm on (a gate of its own, not the strict check 7):
        # within LEVEL0_WITHIN_S of the crowd's end every signal but the
        # SLO burn is below the elevated grade, and the controller kept
        # sampling
        drained_s, sampled = drained_after(poll.pressure[i], t_crowd_end, ov.shed_start * ELEVATED_FRAC)
        if on:
            gate(drained_s <= LEVEL0_WITHIN_S and sampled, f"node {i}: its queue signals not below the elevated "
                 f"grade within {LEVEL0_WITHIN_S} s of the crowd's end ({drained_s:.2f} s) or no sample after it")
        launches = status[i]["build"]["kernel_launches"] - b0["kernel_launches"]
        if kind == "cuda":
            gate(launches > 0, f"node {i}: the verify kernel never launched")
        qw = status[i].get("verifier_stages", {}).get("queue_wait", {})
        top, led = dominant_signal(poll.pressure[i])
        nodes.append({
            "shed_requests": shed_req, "shed_entries": shed_ent,
            "peak_pressure": max((h[4] or 0.0 for h in poll.health(i)), default=0.0),
            "peak_level": max((h[3] or 0 for h in poll.health(i)), default=0),
            "dominant_signal": top, "signal_led": led,
            "level0_after_crowd_s": None if back_s == float("inf") else back_s,
            "queue_peak": st.get("verifier_queue_peak"), "queue_wait_p50_ms": qw.get("p50_ms"),
            "queue_wait_p99_ms": qw.get("p99_ms"), "launches": launches,
            "kernel_busy_share": (launches * by_lanes["ed25519_verify"][256]["ms"] / (1e3 * out["arm_s"])
                                  if by_lanes else None),
            "healthz_hz": rate, "healthz_max_gap_s": max(gaps, default=0.0),
            "healthz_slowest_answer_s": max((h[6] for h in health), default=0.0),
            "healthz_not_ok": dict(Counter(h[5] for h in not_ok)),
            "slo_degraded_s": ((max(h[0] for h in slo_only) - min(h[0] for h in slo_only) + HEALTH_POLL_S)
                               if slo_only else 0.0),
            "drained_after_crowd_s": None if drained_s == float("inf") else drained_s,
            "burn_at_end": (poll.pressure[i][-1][1].get("signals") or {}).get("burn") if poll.pressure[i] else None,
        })
    out["nodes"] = nodes
    out["launches"] = sum(p["launches"] for p in nodes)
    # the strict checks 6 and 7: known misses
    out["strict_check6_held"] = not any(p["healthz_not_ok"] for p in nodes)
    out["strict_check7_held"] = (all(p["level0_after_crowd_s"] is not None
                                    and p["level0_after_crowd_s"] <= LEVEL0_WITHIN_S for p in nodes)
                                if on else None)

    # node PROFILED_NODE's device trace against its launch count
    k1_trace = trace["k1_events"]
    launches3 = nodes[PROFILED_NODE]["launches"]
    gate(k1_trace == launches3, f"node {PROFILED_NODE}'s trace holds {k1_trace} {K1_SYMBOL} events, its "
         f"kernel_launches grew by {launches3}")
    window = trace["window_ms"]
    trace_share = trace["k1_ms"] / window if window else 0.0
    event_share = launches3 * by_lanes["ed25519_verify"][256]["ms"] / window if by_lanes and window else None
    out["trace"] = {**trace, **({"k1_busy_share": trace_share, "event_timed_share": event_share,
                                 "device_idle_share": 1.0 - trace["device_busy_ms"] / window}
                                if kind == "cuda" and window else {})}

    log(f"{label}: steady tier {len(steady_keys)} clients, {n_steady_acked} transfers committed on all {n} "
        f"nodes, {out['steady_tx_per_s']:,.1f} tx/s; acknowledgement to commit on every node (the latest of "
        f"the {n} nodes' /tracez stamps, over the {len(lats)} transfers stamped on all {n}; {partly} partly "
        f"stamped) p50 {p50:.1f} ms, p99 {p99:.1f} ms; Jain's index over the steady senders' commits "
        f"{out['jain']:.4f}; steady calls shed {out['steady_shed']}")
    log(f"{label}: crowd {len(crowd_keys)} clients x {plan['crowd_per']} in chunks of {plan['chunk']}, "
        f"started within {1e3 * out['crowd_start_spread_s']:.1f} ms, {t_crowd - t0:.1f} s in, over for "
        f"{out['crowd_s']:.2f} s: {out['crowd_committed']} committed, {out['crowd_retried']} re-sent after a "
        f"refusal, {out['crowd_refused']} finally refused; refusals {out['refusals']}, "
        f"{out['sheds_before_crowd']} before the crowd; arm {out['arm_s']:.1f} s")
    if on:
        log(f"{label}: check 2 (every refusal RESOURCE_EXHAUSTED with a hint in [{ov.retry_after_ms}, "
            f"{ov.retry_after_max_ms}] ms) over {out['refusals']} refusals"
            + ("" if out["refusals"] else ": held vacuously, the shed sites, their hints and RetryPolicy's "
               "retries did not run in this arm"))
    for i, p in enumerate(nodes):
        busy = p["kernel_busy_share"]
        log(f"{label} node {i}: overload_shed_requests {p['shed_requests']}, overload_shed_entries "
            f"{p['shed_entries']}; peak pressure {p['peak_pressure']}, peak level {p['peak_level']}, the "
            f"signal at the peak {p['dominant_signal']} (readings each signal led: {p['signal_led']}); "
            f"back at level 0 {seconds_or_never(p['level0_after_crowd_s'])} after the crowd's end (every signal "
            f"but burn below the elevated grade {seconds_or_never(p['drained_after_crowd_s'])} after it, burn at "
            f"the last reading {p['burn_at_end']}); verifier queue peak "
            f"{p['queue_peak']}, queue wait p50 {p['queue_wait_p50_ms']} ms p99 {p['queue_wait_p99_ms']} ms; "
            f"verify kernel launches {p['launches']}"
            + (f", kernel busy {100 * busy:.2f}% of the arm (phase 3 times)" if busy is not None else "")
            + f"; /healthz {p['healthz_hz']:.2f} Hz, longest gap {p['healthz_max_gap_s']:.2f} s, slowest answer "
            f"{p['healthz_slowest_answer_s']:.2f} s, answers "
            f"other than 200 ok/overloaded {p['healthz_not_ok'] or 'none'} (503 degraded over "
            f"{p['slo_degraded_s']:.1f} s)")
    log(f"{label}: strict check 6 (200 ok/overloaded at every /healthz poll): "
        f"{'held' if out['strict_check6_held'] else 'MISSED'}"
        + (f"; strict check 7 (every node back at level 0 within "
                                f"{LEVEL0_WITHIN_S:.0f} s of the crowd's end): "
                                f"{'held' if out['strict_check7_held'] else 'MISSED'}" if on else "")
        + " (known misses on the card, open in ROADMAP section 3: printed, not gated; one that holds is "
          "to be gated again)")
    tr = out["trace"]
    log(f"{label} node {PROFILED_NODE} trace (torch.profiler, profile_dir): {tr['events']} events over "
        f"{window:.1f} ms, {k1_trace} {K1_SYMBOL} kernel events, its kernel_launches grew by {launches3}"
        + (f"; K1 busy {100 * trace_share:.3f}% of the trace window from the trace's kernel durations "
           f"({tr['k1_ms']:.3f} ms), {100 * event_share:.3f}% event-timed as phase 6 computes it (launches x "
           f"phase 3's 256-lane time); device idle {100 * tr['device_idle_share']:.3f}% of the window "
           f"(kernels and copies); {card}" if kind == "cuda" and event_share is not None else ""))
    return out


async def overload_path(seed: int, by_lanes, card, card_line: str, kind: str = "cuda",
                        n_steady: int = OVERLOAD_STEADY, n_crowd: int = OVERLOAD_CROWD,
                        crowd_per: int = OVERLOAD_CROWD_PER, chunk: int = OVERLOAD_CHUNK,
                        tail_s: float = STEADY_TAIL_S) -> dict:
    """Phase 13: the served overload A/B, arm off then arm on, the same
    seed, keys and schedule, each on a net of its own. Both nets start
    together and stay up until both arms are over, so each arm runs beside
    the other's idle net; then whether arm on held the reference's bar
    (the steady tier's p99 below arm off's, Jain's index >= 0.8), printed,
    not gated on. A failed check of either arm fails the phase once both
    arms have printed their readings."""
    import tempfile

    t13 = time.perf_counter()
    plan = overload_plan(seed, n_steady, n_crowd, crowd_per, chunk)
    arms, runs, failures = {}, {}, []
    with tempfile.TemporaryDirectory(prefix="at2-phase13-") as workdir:
        nets = {on: overload_net(on, kind, os.path.join(workdir, "on" if on else "off")) for on in (False, True)}
        rcs: dict = {}
        try:
            up_s = start_pair([nets[False], nets[True]], "overload node nets (13)")
            for on in (False, True):
                net, label = nets[on], f"overload node net (13, arm {'on' if on else 'off'})"
                log(f"{label}: {net.n} `server run` processes, [verifier] kind = \"{kind}\", "
                    + ("[overload] enabled = true (every other key at its default)" if on else "no [overload] table")
                    + f", node {PROFILED_NODE} with [observability] profile_dir; both arms' nets up and meshed "
                    f"{up_s:.1f} s after their start, and up until both arms are over")
                runs[on] = await overload_drive(net, on, plan, tail_s)
                await overload_collect(net, runs[on], plan, label)
        finally:
            for net in nets.values():  # both nets shut down side by side
                net.terminate()
            for on, net in nets.items():
                rcs[on] = net.stop()
        for on in (False, True):
            check(rcs[on] == [0] * nets[on].n, f"overload node net (13, arm {'on' if on else 'off'}): servers "
                  f"exited with {rcs[on]} on SIGTERM")
            arms["on" if on else "off"] = overload_readings(nets[on], runs[on], on, plan, by_lanes, card, kind,
                                                            failures)
    from at2_node_tpu_torch.node.config import SloConfig

    off, on_ = arms["off"], arms["on"]
    held_p99 = on_["steady_p99_ms"] < off["steady_p99_ms"]
    held_jain = on_["jain"] >= 0.8
    slo_ms = SloConfig().latency_p99_ms
    shed_on = sum(p["shed_entries"] for p in on_["nodes"])
    seconds = time.perf_counter() - t13
    log(f"overload node net (13): the reference's bar (README: controlled traffic holds the steady tier's "
        f"p99 with fairness >= 0.8): steady p99 {on_['steady_p99_ms']:.1f} ms on against "
        f"{off['steady_p99_ms']:.1f} ms off: {'held' if held_p99 else 'MISSED'}; Jain's index on "
        f"{on_['jain']:.4f}: {'held' if held_jain else 'MISSED'}; entries shed on {shed_on}"
        + ("" if shed_on else " (nothing shed: the bar's comparison ran without the controller acting)")
        + f"; steady p99 under the node's [slo] latency_p99_ms {slo_ms:.0f}: off {off['steady_p99_ms'] < slo_ms}, "
        f"on {on_['steady_p99_ms'] < slo_ms}; strict check 6: off "
        f"{'held' if off['strict_check6_held'] else 'MISSED'}, on {'held' if on_['strict_check6_held'] else 'MISSED'}; "
        f"strict check 7: {'held' if on_['strict_check7_held'] else 'MISSED'} (printed, not gated on); "
        f"phase 13 took {seconds:.1f} s; {card_line}")
    check(not failures, "phase 13: " + "; ".join(failures))
    return {"overload_off": off, "overload_on": on_, "held_p99": held_p99, "held_jain": held_jain,
            "launches": off["launches"] + on_["launches"], "seconds": seconds}


# -- phase 14 --------------------------------------------------------------


AB_WORKLOADS = ("flash_crowd", "hot_account")
# the reference bench's population and run length (run_overload_ab)
AB_CLIENTS = 120
AB_CROWD = 80
AB_DURATION_S = 12.0
# the share of AB_DURATION_S a workload's schedule runs: hot_account's is
# cut to a quarter (no gate reads its depth) to keep a call under 700 s;
# flash_crowd keeps the reference's 12 s, whose crowd gate (c) sheds
AB_DEPTH = {"flash_crowd": 1.0, "hot_account": 1 / 4}
AB_RETRY_BUDGET = 4  # the reference cell's retry_budget
AB_FAIRNESS_FLOOR = 0.8  # the reference cell's fairness_floor
# the reference cell's f = 1 of 4 nodes: SimNet's thresholds, two peers
AB_THRESHOLDS = "echo_threshold = 2\nready_threshold = 2\n"
AB_LATENESS_P99_S = 0.5  # gate (e): the p99 of a send's lateness against its offered time
AB_CHANNELS = 4  # gRPC channels (a TCP connection each) a sender process opens to its node
# sender processes a node: with one, a sender's event loop fell 0.96 s
# behind the flash crowd's burst (gate (e)) while the node was not at fault
AB_SENDERS_PER_NODE = 2
AB_LEAD_S = 1.0  # the schedule starts this long after every sender is ready
AB_SETTLE_S = 120.0  # every node reaches every sender's expected sequence within this
AB_QUIET_S = 0.5  # the committed counts hold still this long before the sequences are read
# a call the server's event loop has not taken up this long is cancelled by
# grpc (its max unrequested time in server, 30 s by default)
AB_UNREQUESTED_S = 29.5
# the intake measurement that sizes the cells (C_tx) offers transfers open
# loop within the burst's window at this rate: above any net's intake on
# the card (1,878.2 tx/s at most), and few enough (3,000 in 1.2 s) that
# at the lowest intake seen (353.8 tx/s) the last offer waits under 10 s,
# a third of grpc's unrequested limit
INTAKE_RATE = 2500.0


def ab_sender_main(conn) -> None:
    """A phase-14 sender process: it serves jobs from ``conn`` (a Pipe end)
    until ``("stop",)``. A job is ``("schedule", port, job)``; the sender
    prepares it (keys, signatures, channels to the node's RPC port), answers
    ``("ready", seconds)``, takes ``("go", t_go)`` (a ``time.monotonic()``
    instant: the clock is system-wide) and answers with the job's result,
    or ``("error", text)``."""
    import traceback

    while True:
        msg = conn.recv()
        if msg[0] == "stop":
            return
        try:
            check(msg[0] == "schedule", f"no sender job {msg[0]!r}")
            conn.send(asyncio.run(_sender_schedule(conn, *msg[1:])))
        except Exception:
            conn.send(("error", traceback.format_exc()))


async def _sender_channels(port: int) -> tuple:
    """AB_CHANNELS channels to 127.0.0.1:port, each its own connection
    (a local subchannel pool), connected; their stubs."""
    import grpc

    from at2_node_tpu_torch.proto.rpc import At2Stub

    channels = [grpc.aio.insecure_channel(f"127.0.0.1:{port}", options=[("grpc.use_local_subchannel_pool", 1)])
                for _ in range(AB_CHANNELS)]
    await asyncio.gather(*(asyncio.wait_for(ch.channel_ready(), 30) for ch in channels))
    return channels, [At2Stub(ch) for ch in channels]


async def _sender_schedule(conn, port: int, job: dict) -> tuple:
    """One node's share of an arm's schedule: every event (index, t,
    sender key, seq, recipient, amount) is signed beforehand, then sent
    as one unary ``SendAsset`` at ``t_go + t`` through
    ``RetryPolicy(budget=job["budget"])`` with a seeded rng. Returns a
    record an event: (index, the monotonic instant its first attempt was
    issued, the instant its call ended, "ack" or the final status code's
    name, every refusal as (instant, code name, retry_after_ms hint or
    None), every attempt's start), and the process's CPU seconds from
    ``t_go`` to its end."""
    import random

    import grpc

    from at2_node_tpu_torch.client import RetryPolicy
    from at2_node_tpu_torch.crypto.keys import SignKeyPair
    from at2_node_tpu_torch.node.overload import parse_retry_after_ms
    from at2_node_tpu_torch.proto import at2_pb2 as pb
    from at2_node_tpu_torch.types import transfer_signing_bytes

    t0 = time.perf_counter()
    kps = {k: SignKeyPair(k) for k in {ev[2] for ev in job["events"]}}
    reqs = []
    for idx, t, key, seq, to, amount in job["events"]:
        kp = kps[key]
        reqs.append((idx, t, pb.SendAssetRequest(
            sender=kp.public, sequence=seq, recipient=to, amount=amount,
            signature=kp.sign(transfer_signing_bytes(kp.public, seq, to, amount)))))
    channels, stubs = await _sender_channels(port)
    conn.send(("ready", time.perf_counter() - t0))
    t_go = conn.recv()[1]
    policy = RetryPolicy(budget=job["budget"], rng=random.Random(job["rng_seed"]).random)
    out: list = []

    async def one(k: int, idx: int, t: float, req) -> None:
        stub, refusals, starts = stubs[k % len(stubs)], [], []
        await asyncio.sleep(max(0.0, t_go + t - time.monotonic()))
        t_issue = time.monotonic()

        async def attempt():
            starts.append(time.monotonic())
            try:
                return await stub.SendAsset(req)
            except grpc.aio.AioRpcError as exc:
                refusals.append((time.monotonic(), exc.code().name, parse_retry_after_ms(exc.details())))
                raise

        try:
            await policy.run(attempt)
            outcome = "ack"
        except grpc.aio.AioRpcError as exc:
            outcome = exc.code().name
        out.append((idx, t_issue, time.monotonic(), outcome, refusals, starts))

    cpu0 = time.process_time()
    try:
        await asyncio.gather(*(one(k, *r) for k, r in enumerate(reqs)))
    finally:
        for ch in channels:
            await ch.close()
    return "done", out, time.process_time() - cpu0


class ABSenders:
    """``n`` spawned ``ab_sender_main`` processes, sender j sending to node
    j mod NET_NODES of whichever net a job names; they live through phase
    14 and are stopped by ``close``."""

    def __init__(self, n: int = NET_NODES * AB_SENDERS_PER_NODE) -> None:
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        self.conns, self.procs = [], []
        for _ in range(n):
            mine, theirs = ctx.Pipe()
            proc = ctx.Process(target=ab_sender_main, args=(theirs,), daemon=True)
            proc.start()
            theirs.close()
            self.conns.append(mine)
            self.procs.append(proc)

    def _recv(self, i: int, timeout: float):
        check(self.conns[i].poll(timeout), f"sender {i} answered nothing in {timeout:.0f} s")
        msg = self.conns[i].recv()
        check(msg[0] != "error", f"sender {i} failed: {msg[-1]}")
        return msg

    def run(self, jobs: list, timeout: float = 600.0) -> tuple:
        """Job i to sender i; once every sender is ready, one ``t_go``
        AB_LEAD_S ahead for all; (t_go, the ready messages, the results)."""
        for conn, job in zip(self.conns, jobs):
            conn.send(job)
        ready = [self._recv(i, timeout) for i in range(len(jobs))]
        t_go = time.monotonic() + AB_LEAD_S
        for conn in self.conns[:len(jobs)]:
            conn.send(("go", t_go))
        return t_go, ready, [self._recv(i, timeout) for i in range(len(jobs))]

    def close(self) -> None:
        for conn, proc in zip(self.conns, self.procs):
            try:
                conn.send(("stop",))
            except OSError:
                pass
            proc.join(timeout=10)
            if proc.is_alive():
                proc.kill()
                proc.join()


def ab_n_tx(c_tx: float, capacity_frac: float, duration: float) -> int:
    """The reference bench sizes its modeled verifier from the schedule
    (capacity = capacity_frac x the offered rate); served, the capacity is
    measured, so the schedule is sized from it: ``duration`` seconds of
    ``c_tx`` over ``capacity_frac``."""
    return int(round(duration * c_tx / capacity_frac))


def ab_schedule(seed: int, workload: str, nodes: int, n_clients: int, crowd: int, n_tx: int,
                duration: float) -> list:
    """The reference cell's schedule (``run_overload_cell``): its seed
    derivation, the port's copy of its generator."""
    import random

    from at2_node_tpu_torch.sim.scenarios import _seed_int, flash_crowd_workload, hot_account_workload

    rng = random.Random(_seed_int("overload", seed, workload, n_clients, crowd, n_tx))
    if workload == "flash_crowd":
        return flash_crowd_workload(rng, nodes=nodes, n_clients=n_clients, n_tx=n_tx, duration=duration,
                                    crowd=crowd)
    check(workload == "hot_account", f"no overload variant for workload {workload!r}")
    return hot_account_workload(rng, nodes=nodes, n_clients=n_clients, n_tx=n_tx, duration=duration)


def ab_steady_ids(workload: str, n_clients: int, crowd: int) -> list:
    """The reference cell's steady tier: the first n_clients - crowd
    clients under a flash crowd, every client but the hot one (0)."""
    return list(range(max(1, n_clients - crowd))) if workload == "flash_crowd" else list(range(1, n_clients))


def ab_table(ov, trace_cap: int) -> str:
    """An arm's TOML tables: ``[observability]`` with the trace and
    recorder caps, and, given an ``OverloadConfig``, ``[overload]`` with
    every key of it written out."""
    import dataclasses

    def value(v) -> str:
        return ("true" if v else "false") if isinstance(v, bool) else repr(v)

    text = f"[observability]\ntrace_cap = {trace_cap}\ntrace_done_cap = {trace_cap}\nrecorder_cap = {trace_cap}\n"
    if ov is not None:
        text += "\n[overload]\n" + "".join(f"{f.name} = {value(getattr(ov, f.name))}\n"
                                           for f in dataclasses.fields(ov))
    return text


def ab_expected(acked: dict, offered: dict) -> tuple:
    """The expected transfers: a sender's acknowledged sequences up to its
    first sequence that was not acknowledged (``acked`` and ``offered``:
    sender -> set of sequences). Returns {sender: its last expected
    sequence} and {sender: the sequences acknowledged behind a gap}
    (they park at the ledger's sequence gate)."""
    last, parked = {}, {}
    for sender, seqs in offered.items():
        got = acked.get(sender, set())
        s = 0
        while s + 1 in got:
            s += 1
        last[sender] = s
        behind = sorted(q for q in got if q > s)
        if behind:
            parked[sender] = behind
    return last, parked


def ab_replay(order: list, transfers: dict, expected_last: dict, initial: int) -> tuple:
    """A node's ledger under the ledger's own rule (``ledger/account.py``),
    in the node's commit order. ``order``: the (sender, seq) of each
    ``committed`` stamp, in the order the node's completed-trace ring took
    them (its commit order); ``transfers``: every scheduled (sender, seq)
    -> (recipient, amount); ``expected_last``: each sender's last
    expected sequence. An expected transfer the node did not commit
    failed its debit: its sequence is consumed and no money moves, which
    the rule allows only when its amount is above the sender's balance
    right after its predecessor (later, only a credit can raise it).
    Returns ({sender: [last_sequence, balance]}, the transfers that
    failed their debit, the faults)."""
    state: dict = {}  # sender -> [last sequence, balance, balance right after its last debit]
    overdrawn, faults = [], []

    def acct(key) -> list:
        return state.setdefault(key, [0, initial, initial])

    def failed_before(sender, seq: int) -> None:
        s = acct(sender)
        while s[0] + 1 < seq and s[0] < expected_last.get(sender, 0):
            to, amount = transfers[(sender, s[0] + 1)]
            if to == sender or amount <= s[2]:
                faults.append(f"{sender.hex()[:12]}/{s[0] + 1}: expected and affordable ({amount} against "
                              f"{s[2]}), not committed")
            else:
                overdrawn.append((sender, s[0] + 1))
            s[0] += 1

    for sender, seq in order:
        if seq > expected_last.get(sender, 0):
            faults.append(f"{sender.hex()[:12]}/{seq}: committed, not an expected transfer")
            continue
        failed_before(sender, seq)
        s = acct(sender)
        if s[0] + 1 != seq:
            faults.append(f"{sender.hex()[:12]}/{seq}: committed after sequence {s[0]}")
            continue
        to, amount = transfers[(sender, seq)]
        s[0] = seq
        if to != sender:  # a transfer to itself moves nothing (Accounts._transfer)
            if amount > s[1]:
                faults.append(f"{sender.hex()[:12]}/{seq}: committed {amount} against a balance of {s[1]}")
                continue
            s[1] -= amount
            acct(to)[1] += amount
        s[2] = s[1]
    for sender, last in expected_last.items():
        failed_before(sender, last + 1)
    return {k: s[:2] for k, s in state.items()}, overdrawn, faults


def ab_latencies(traces: list, offered_at: dict, steady: set) -> tuple:
    """The reference cell's client-perceived latency
    (``run_overload_cell``): from a transfer's offered time to the latest
    of its ``committed`` stamps on the nodes' ``/tracez``, retry hold-offs
    included; here only over transfers stamped on every node. Returns the
    steady tier's and all transfers' latencies (s, ascending) and how many
    offered transfers were stamped on how many nodes."""
    commit_at: dict = {}
    for i, dump in enumerate(traces):
        for rec in dump["completed"] + dump["live"]:
            for stage, mono, _ in rec["stages"]:
                if stage == "committed":
                    commit_at.setdefault((rec["sender"], rec["seq"]), {})[i] = mono
    steady_lats, all_lats, stamped_on = [], [], Counter()
    for key, stamps in commit_at.items():
        t0 = offered_at.get(key)
        if t0 is None:
            continue
        stamped_on[len(stamps)] += 1
        if len(stamps) < len(traces):
            continue
        lat = max(stamps.values()) - t0
        all_lats.append(lat)
        if key[0] in steady:
            steady_lats.append(lat)
    return sorted(steady_lats), sorted(all_lats), dict(stamped_on)


AB_SEGMENTS = ("offered_to_ingress", "ingress_to_admitted", "admitted_to_delivered", "delivered_to_last_commit")


def ab_stages(traces: list, offered_at: dict, keys: set) -> dict:
    """Where a transfer's offered-to-commit time went, over the transfers
    of ``keys`` stamped committed on every node: offered to the ingress
    stamp of the node that admitted it (the client's issue, the RPC
    queue, retry hold-offs), ingress to admitted (admission's verify),
    admitted to delivered there (the broadcast), delivered there to the
    last node's commit. {segment: (p50 ms, p99 ms)}."""
    from at2_node_tpu_torch.tools.trace_collect import _pctl

    origin, commits = {}, {}
    for i, dump in enumerate(traces):
        for rec in dump["completed"]:
            if rec["terminal"] != "committed":
                continue
            key = (rec["sender"], rec["seq"])
            stamps = {stage: mono for stage, mono, _ in rec["stages"]}
            commits.setdefault(key, []).append(stamps["committed"])
            if rec["origin"]:
                origin[key] = stamps
    seg: dict = {name: [] for name in AB_SEGMENTS}
    for key, st in origin.items():
        if key not in keys or len(commits[key]) < len(traces) or not {"ingress", "admitted", "delivered"} <= set(st):
            continue
        for name, a, b in zip(AB_SEGMENTS, (offered_at[key], st["ingress"], st["admitted"], st["delivered"]),
                              (st["ingress"], st["admitted"], st["delivered"], max(commits[key]))):
            seg[name].append(b - a)
    return {name: (round(1e3 * _pctl(sorted(v), 0.50), 3), round(1e3 * _pctl(sorted(v), 0.99), 3))
            for name, v in seg.items()}


async def ab_short(clients: list, pubs: list, expected_last: dict) -> list:
    """The (node, client) pairs whose ``GetLastSequence`` is not the
    client's last expected sequence (``clients[i]`` talks to node i)."""
    seqs = [await asyncio.gather(*(cl.get_last_sequence(p) for p in pubs)) for cl in clients]
    return [(i, c) for i, row in enumerate(seqs) for c, p in enumerate(pubs) if row[c] != expected_last.get(p.hex(), 0)]


def ab_fairness(frontier: dict, offered_by_client: list, steady_ids: list, pubs: list) -> float:
    """The reference cell's fairness: Jain's index over the steady
    senders' committed/offered ratios, a sender's committed count being
    its last sequence on node 0."""
    from at2_node_tpu_torch.sim.scenarios import jain_index

    ratios = [float(frontier.get(pubs[i], 0)) / offered_by_client[i] for i in steady_ids if offered_by_client[i] > 0]
    return round(jain_index(ratios), 6)


def level0_after(readings: list, t_from: float):
    """From a node's /healthz readings: seconds after ``t_from`` to the
    first level-0 reading after the last one above 0 (0.0 if none was
    above 0 after it; None if the last reading is above 0)."""
    after = [h for h in readings if h[0] >= t_from and h[1] is not None]
    high = [k for k, h in enumerate(after) if h[3]]
    if not high:
        return 0.0
    return after[high[-1] + 1][0] - t_from if high[-1] + 1 < len(after) else None


AB_SIGNALS = ("occupancy", "sojourn", "backlog", "tail", "burn")  # the controller's five (node/overload.py)


def level2_margin(readings: list, t_from: float, t_burst: float, last_admitted) -> tuple:
    """From a node's /healthz readings: its first level-2 (or higher)
    reading at or after ``t_from``, in seconds after ``t_burst`` (the
    burst's first offer), and the margin in seconds from it to
    ``last_admitted`` (the node's last crowd admission, an instant), which
    is negative when level 2 came after it; None for what did not come."""
    first = next((h[0] for h in readings if h[0] >= t_from and h[1] is not None and (h[3] or 0) >= 2), None)
    level2_s = None if first is None else round(first - t_burst, 3)
    margin = None if first is None or last_admitted is None else round(last_admitted - first, 3)
    return level2_s, margin


def first_over(blocks: list, t_from: float, threshold: float) -> tuple:
    """From a node's /statusz pressure blocks: the first reading at or
    after ``t_from`` whose pressure is at least ``threshold``, as (its
    instant, the signal that was largest there); (None, None) if none."""
    for t, b in blocks:
        sig = b.get("signals") or {}
        if t >= t_from and b.get("pressure", 0.0) >= threshold and sig:
            return t, max(sig, key=sig.get)
    return None, None


def last_commits(traces: list, keys=None) -> list:
    """The instants at which transfers (of ``keys``, every one if None)
    stamped ``committed`` on every node's ``/tracez`` got their last
    node's stamp, ascending."""
    stamps: dict = {}
    for i, dump in enumerate(traces):
        for rec in dump["completed"] + dump["live"]:
            key = (rec["sender"], rec["seq"])
            if keys is None or key in keys:
                for stage, mono, _ in rec["stages"]:
                    if stage == "committed":
                        stamps.setdefault(key, {})[i] = mono
    return sorted(max(s.values()) for s in stamps.values() if len(s) == len(traces))


def commit_rate(commits: list, t_from: float, t_to: float):
    """Transfers a second whose last commit (``last_commits``) fell in
    [t_from, t_to]; None for an empty window."""
    if t_to <= t_from:
        return None
    return sum(1 for t in commits if t_from <= t <= t_to) / (t_to - t_from)


def ab_net(kind: str, workdir: str, ov, trace_cap: int) -> ServerNet:
    """An arm's four ``server run`` nodes at the reference cell's f = 1
    thresholds, ``ab_table``'s tables on every node."""
    os.makedirs(workdir)
    return ServerNet(kind, workdir, top=AB_THRESHOLDS, tables=lambda i: ab_table(ov, trace_cap))


def start_pair(nets: list, label: str) -> float:
    """Start nets side by side in threads (their ports from one
    ``free_ports`` call); seconds until all were up and meshed. A port
    that another socket took between ``free_ports`` and its node's bind
    makes that node exit: then every node stops and the nets start once
    more on fresh ports."""
    t0 = time.perf_counter()
    for attempt in (0, 1):
        ports = free_ports(2 * sum(net.n for net in nets))
        try:
            with ThreadPoolExecutor(max_workers=len(nets)) as pool:
                list(pool.map(lambda k: nets[k].start(180.0, ports[2 * NET_NODES * k:2 * NET_NODES * (k + 1)]),
                              range(len(nets))))
            break
        except RuntimeError as exc:
            if attempt or not any(m in str(exc) for m in ("Address already in use", "cannot bind")):
                raise
            log(f"{label}: a port was taken before its node bound it ({exc}); starting again on fresh ports")
            for net in nets:
                net.stop()
                net.procs, net.logs, net.tomls = [], [], []
    up = time.perf_counter() - t0
    log(f"{label}: {len(nets)} net{'s' if len(nets) > 1 else ''} of {NET_NODES} `server run` processes up and "
        f"meshed in {up:.1f} s")
    return up


def ab_jobs(net: ServerNet, events: list, keys: list, m: int, rng_seed: str) -> list:
    """The senders' jobs for a schedule on ``net``: sender j takes every
    (m / n)-th event of node j mod n, in order, each event (index, t,
    the sender's private key, seq, recipient, amount), RetryPolicy(budget
    AB_RETRY_BUDGET) with its own seeded rng."""
    n = net.n
    pubs = [kp.public for kp in keys]
    by_node = [[(k, t, keys[a["client"]].private_bytes, a["seq"], pubs[a["to"]], a["amount"])
                for k, (t, _, a) in enumerate(events) if a["node"] == i] for i in range(n)]
    return [("schedule", net.rpc_ports[j % n], {"events": by_node[j % n][j // n::m // n], "budget": AB_RETRY_BUDGET,
                                                 "rng_seed": f"{rng_seed}/{j}"}) for j in range(m)]


def intake_events(seed, n_keys: int, nodes: int, rate: float, seconds: float) -> list:
    """The intake measurement's offer, in the shape of the flash crowd's
    burst (``flash_crowd_workload``): rate x seconds transfers, each at a
    uniform time in the window to a uniform node, from the keys in turn,
    a sender's sequences in time order (the reference's ``_finish_txs``),
    each to one of the keys, amount 1-20."""
    import random

    from at2_node_tpu_torch.sim.scenarios import _finish_txs

    rng = random.Random(f"{seed}/intake")
    raw = [(rng.uniform(0.0, seconds), rng.randrange(nodes), i % n_keys) for i in range(int(round(rate * seconds)))]
    return _finish_txs(rng, raw, n_keys)


def intake_rate(commits: list) -> float:
    """A net's intake from the instants its offered transfers were
    committed everywhere (``last_commits``, ascending): the commits
    between the 10th and 90th percentile over the time between them,
    which leaves out the ramp before the net was full and the tail after
    its backlog ran out."""
    lo = len(commits) // 10
    hi = len(commits) - 1 - lo
    check(hi > lo and commits[hi] > commits[lo], f"too few commits to take a rate from: {len(commits)}")
    return (hi - lo) / (commits[hi] - commits[lo])


async def measure_intake(net: ServerNet, senders: ABSenders, seed: int, crowd: int, duration: float, trace_cap: int,
                         label: str) -> dict:
    """C_tx on the net that runs an arm: ``crowd`` fresh keys offer
    INTAKE_RATE transfers a second over the burst's window (a tenth of
    ``duration``, ``flash_crowd_workload``'s) in the burst's shape
    (``intake_events``) as
    unary ``SendAsset`` through the senders, open loop; every one must be
    acknowledged, commit on every node and equal the python-int replay,
    and the net drains (its committed counts hold still AB_QUIET_S).
    Returns the intake (``intake_rate`` over every node's ``/tracez``
    commit stamps), the signatures the four verifiers checked a committed
    transfer, how long the backlog outlasted the offer, and K1 launches a
    node."""
    from at2_node_tpu_torch.crypto.keys import SignKeyPair

    n = net.n
    rng = np.random.default_rng(seed + 14)
    keys = [SignKeyPair(rng.bytes(32)) for _ in range(crowd)]
    window = 0.1 * duration
    events = intake_events(seed, len(keys), n, INTAKE_RATE, window)
    before = [net.statusz(i) for i in range(n)]
    t_go, _, done = senders.run(ab_jobs(net, events, keys, len(senders.conns), f"{seed}/intake"))
    records = [r for _, recs, _ in done for r in recs]
    refused = Counter(outcome for _, _, _, outcome, _, _ in records if outcome != "ack")
    check(not refused and len(records) == len(events), f"{label}: {len(records)} of {len(events)} sent, "
          f"refused {dict(refused)}")
    wait_committed(net, [b["stats"]["committed"] + len(events) for b in before], AB_SETTLE_S)
    counts, t_still = None, time.monotonic()
    while counts is None or time.monotonic() - t_still < AB_QUIET_S:
        now_counts = [net.committed(i) for i in range(n)]
        if now_counts != counts:
            counts, t_still = now_counts, time.monotonic()
        await asyncio.sleep(0.1)
    with ThreadPoolExecutor(max_workers=n) as pool:
        after = list(pool.map(net.statusz, range(n)))
        traces = list(pool.map(lambda i: json.loads(net.get(i, f"/tracez?limit={trace_cap}")), range(n)))
    per_key: list = [[] for _ in keys]
    for _, _, a in events:
        per_key[a["client"]].append((a["seq"], keys[a["to"]].public, a["amount"]))
    await check_replay(net, keys, per_key)
    commits = last_commits(traces, {(keys[a["client"]].public.hex(), a["seq"]) for _, _, a in events})
    check(len(commits) == len(events), f"{label}: {len(commits)} of {len(events)} transfers stamped committed on "
          f"every node's /tracez")
    sigs = sum(a["stats"]["verifier_signatures"] - b["stats"]["verifier_signatures"] for a, b in zip(after, before))
    out = {"tx_per_s": intake_rate(commits), "transfers": len(events), "offered_per_s": INTAKE_RATE,
           "sigs_per_tx": sigs / len(events), "first_commit_s": commits[0] - t_go,
           "backlog_s": commits[-1] - (t_go + events[-1][0]),
           "launches": [a["build"]["kernel_launches"] - b["build"]["kernel_launches"] for a, b in zip(after, before)]}
    log(f"{label}: {len(keys)} fresh keys offered {len(events)} unary SendAsset open loop in {window:g} s "
        f"({INTAKE_RATE:,.0f} tx/s), all acknowledged, committed on all {n} nodes and equal to the python-int "
        f"replay; intake (the commits between the 0.1 and 0.9 quantiles) "
        f"{out['tx_per_s']:,.1f} tx/s, the first commit {out['first_commit_s']:.3f} s after the first offer, the "
        f"last {out['backlog_s']:.3f} s after the last; {out['sigs_per_tx']:.2f} signatures verified a committed "
        f"transfer over the {n} nodes (the reference's _OVERLOAD_SIGS_PER_TX: 33); K1 launches {out['launches']}")
    return out


async def ab_arm(net: ServerNet, senders: ABSenders, plan: dict, controlled: bool, kind: str,
                 failures: list) -> dict:
    """One arm on its started net: the steady tier registers, the schedule
    runs in real time through the senders, every node reaches each
    sender's expected sequence; then the ledgers, traces, recorders and
    counters are read (net still up) into the arm's row, and what fails
    gates (a)-(e) is appended to ``failures``."""
    from at2_node_tpu_torch.client import Client
    from at2_node_tpu_torch.ledger.account import INITIAL_BALANCE
    from at2_node_tpu_torch.tools.trace_collect import _pctl

    n, workload, arm = net.n, plan["workload"], "controlled" if controlled else "uncontrolled"
    label = f"overload A/B node net (14, {workload}, {arm})"
    keys, events, steady_ids, ov = plan["keys"], plan["events"], plan["steady_ids"], plan["table"]
    pubs = [kp.public for kp in keys]
    hexes = [p.hex() for p in pubs]

    def gate(cond: bool, what: str) -> None:
        if not cond:
            failures.append(f"{label}: {what}")

    clients = [Client(f"http://127.0.0.1:{p}") for p in net.rpc_ports]
    try:
        t_reg = time.monotonic()
        size = await register_keys(net, clients, [keys[c] for c in steady_ids], steady_ids)
        t_reg = time.monotonic() - t_reg
        status0 = [net.statusz(i) for i in range(n)]
        drops0 = [drop_counters(net.metrics(i)) for i in range(n)]
        jobs = ab_jobs(net, events, keys, len(senders.conns), f"{plan['seed']}/{workload}/{arm}")
        with Poller(net) as poll:
            t_go, ready, done = senders.run(jobs)
            t_sent = time.monotonic()
            records = [r for _, recs, _ in done for r in recs]
            offered = {}
            for _, _, a in events:
                offered.setdefault(hexes[a["client"]], set()).add(a["seq"])
            acked: dict = {}
            for idx, _, _, outcome, _, _ in records:
                a = events[idx][2]
                if outcome == "ack":
                    acked.setdefault(hexes[a["client"]], set()).add(a["seq"])
            expected_last, parked = ab_expected(acked, offered)
            # every node reaches each sender's last expected sequence (an
            # overdrawn debit consumes its sequence too), with nothing left
            # undelivered: once every node's committed count (/healthz) has
            # held still for AB_QUIET_S, the sequences are read
            t_end = time.monotonic() + AB_SETTLE_S
            counts, t_settled, t_checked, short = None, time.monotonic(), 0.0, []
            while True:
                now_counts = [net.committed(i) for i in range(n)]
                if now_counts != counts:
                    counts, t_settled = now_counts, time.monotonic()
                elif time.monotonic() - max(t_settled, t_checked) >= AB_QUIET_S:
                    short = await ab_short(clients, pubs, expected_last)
                    if not short and not any(net.stats(i)["slots_undelivered"] for i in range(n)):
                        break
                    t_checked = time.monotonic()
                if time.monotonic() > t_end:
                    gate(False, f"{len(short)} (node, sender) pairs short of the expected sequence "
                         f"{AB_SETTLE_S:.0f} s after the schedule, e.g. {short[:4]}")
                    break
                await asyncio.sleep(0.1)
        t_read = time.monotonic()
        seqs = [await asyncio.gather(*(cl.get_last_sequence(p) for p in pubs)) for cl in clients]
        balances = [await asyncio.gather(*(cl.get_balance(p) for p in pubs)) for cl in clients]
    finally:
        for cl in clients:
            await cl.close()
    with ThreadPoolExecutor(max_workers=n) as pool:
        status = list(pool.map(net.statusz, range(n)))
        metrics = list(pool.map(net.metrics, range(n)))
        debugz = list(pool.map(lambda i: json.loads(net.get(i, "/debugz")), range(n)))
        traces = list(pool.map(lambda i: json.loads(net.get(i, f"/tracez?limit={plan['trace_caps'][controlled]}")),
                               range(n)))
    collect_s = time.monotonic() - t_read
    # this arm's transfers (the intake measurement ran on flash_crowd's
    # uncontrolled net before its arm, from keys of its own)
    mine = set(hexes)
    traces = [{k: [r for r in d[k] if r["sender"] in mine] for k in ("completed", "live")} for d in traces]

    # the schedule as sent
    t_offer = {k: t_go + t for k, (t, _, _) in enumerate(events)}
    late = sorted(t_issue - t_offer[idx] for idx, t_issue, *_ in records)
    lateness_p99 = _pctl(late, 0.99)
    refusals = [(idx, r) for idx, _, _, _, rs, _ in records for r in rs]
    final = Counter(outcome for _, _, _, outcome, _, _ in records)
    retried = {idx for idx, _, _, outcome, rs, _ in records if rs and outcome == "ack"}
    # RetryPolicy honours the typed hint: each retry starts no sooner after
    # the refusal it follows than the hint (capped at the policy's max_ms)
    # times the policy's least jitter factor
    from at2_node_tpu_torch.client import RetryPolicy

    pol = RetryPolicy()
    floor = 1.0 - pol.jitter / 2.0
    n_retries = sum(len(starts) - 1 for *_, starts in records)
    early = [(idx, round(b - r[0], 4), r[2]) for idx, _, _, _, rs, starts in records
             for r, b in zip(rs, starts[1:]) if r[2] is not None and b - r[0] < floor * min(pol.max_ms, r[2]) / 1e3]
    n_parked = sum(len(v) for v in parked.values())
    n_expected = sum(expected_last.values())

    # (a) every expected transfer commits on every node, by the ledger's rule
    transfers = {(pubs[a["client"]], a["seq"]): (pubs[a["to"]], a["amount"]) for _, _, a in events}
    last_by_pub = {pubs[c]: expected_last.get(hexes[c], 0) for c in range(len(pubs))}
    commit_orders, overdrawn, ledgers_ok = [], [], []
    for i in range(n):
        order = [(bytes.fromhex(r["sender"]), r["seq"]) for r in traces[i]["completed"] if r["terminal"] == "committed"]
        commit_orders.append(order)
        replay, over, faults = ab_replay(order, transfers, last_by_pub, INITIAL_BALANCE)
        overdrawn.append(len(over))
        gate(not faults, f"node {i}: {len(faults)} transfers against the ledger's rule, e.g. {faults[:3]}")
        wrong = [(p.hex()[:12], [seqs[i][c], balances[i][c]], replay.get(p, [0, INITIAL_BALANCE]))
                 for c, p in enumerate(pubs) if [seqs[i][c], balances[i][c]] != replay.get(p, [0, INITIAL_BALANCE])]
        gate(not wrong, f"node {i}: {len(wrong)} accounts differ from the replay in its commit order "
             f"(account, the node's [sequence, balance], the replay's), e.g. {wrong[:3]}")
        ledgers_ok.append(not faults and not wrong)
        committed_i = status[i]["stats"]["committed"] - status0[i]["stats"]["committed"]
        gate(committed_i == len(order), f"node {i}: committed {committed_i}, its /tracez stamped {len(order)}")
        gate(status[i]["stats"]["slots_undelivered"] == 0,
             f"node {i}: slots_undelivered {status[i]['stats']['slots_undelivered']}")
        drops = drop_counters(metrics[i])
        gate(drops == drops0[i], f"node {i}: drop counters moved: {drops0[i]} -> {drops}")

    # the reference's cell readings
    steady = {hexes[c] for c in steady_ids}
    offered_at = {(hexes[a["client"]], a["seq"]): t_offer[k] for k, (_, _, a) in enumerate(events)}
    steady_lats, all_lats, stamped_on = ab_latencies(traces, offered_at, steady)
    stages = ab_stages(traces, offered_at, {k for k in offered_at if k[0] in steady})
    offered_by_client = [0] * len(keys)
    for _, _, a in events:
        offered_by_client[a["client"]] += 1
    fairness = ab_fairness({pubs[c]: seqs[0][c] for c in range(len(pubs))}, offered_by_client, steady_ids, pubs)
    shed = [int(m.get("at2_overload_shed_entries_total", 0) + m.get("at2_overload_shed_distilled_total", 0))
            for m in metrics]
    shed_req = [int(m.get("at2_overload_shed_requests_total", 0)) for m in metrics]
    shed_events = [sum(1 for ev in d["recorder"]["events"] if ev[1] in ("overload_shed", "overload_shed_distilled"))
                   for d in debugz]
    steady_p99 = round(1e3 * _pctl(steady_lats, 0.99), 3)
    slo_ms = plan["latency_slo_ms"]
    launches = [status[i]["build"]["kernel_launches"] - status0[i]["build"]["kernel_launches"] for i in range(n)]
    t_sched_end = t_go + max(t for t, _, _ in events)
    # when the crowd was admitted at each node against when its controller
    # first read level 2 or more (the shed ramp's start), in seconds from
    # the burst's first offer: a level that comes after the last admission
    # finds no crowd left to shed
    crowd = {hexes[c] for c in range(len(keys))} - steady if workload == "flash_crowd" else set()
    t_burst = min((t_offer[k] for k, (_, _, a) in enumerate(events) if hexes[a["client"]] in crowd), default=t_go)
    nodes = []
    for i in range(n):
        health = [h for h in poll.health(i) if h[1] is not None]
        top, led = dominant_signal(poll.pressure[i])
        qw = status[i].get("verifier_stages", {}).get("queue_wait", {})
        admitted = sorted(st["admitted"] for st in ({stage: mono for stage, mono, _ in rec["stages"]}
                                                    for rec in traces[i]["completed"] + traces[i]["live"]
                                                    if rec["origin"] and rec["sender"] in crowd) if "admitted" in st)
        level2_s, margin = level2_margin(health, t_go, t_burst, admitted[-1] if admitted else None)
        t_over, over_signal = first_over(poll.pressure[i], t_go, ov.shed_start) if ov is not None else (None, None)
        # the controller's readings from the burst's first offer to the
        # crowd's last admission: (s after the offer, pressure, AB_SIGNALS)
        series = [(round(t - t_burst, 2), b.get("pressure"), [(b.get("signals") or {}).get(s) for s in AB_SIGNALS])
                  for t, b in poll.pressure[i] if admitted and t_burst <= t <= admitted[-1]]
        nodes.append({
            "crowd_admitted_s": [round(admitted[0] - t_burst, 3), round(admitted[-1] - t_burst, 3)]
            if admitted else None,
            "level2_s": level2_s, "level2_margin_s": margin if crowd else None,
            "over_shed_start": None if t_over is None else [round(t_over - t_burst, 3), over_signal],
            "pressure_series": series if crowd else None,
            "peak_level": max((h[3] or 0 for h in health), default=0),
            "peak_pressure": max((h[4] or 0.0 for h in health), default=0.0),
            "peak_signal": top, "signal_led": led,
            "burn_end": (poll.pressure[i][-1][1].get("signals") or {}).get("burn") if poll.pressure[i] else None,
            "level0_s": level0_after(health, t_sched_end),
            "queue_peak": status[i]["stats"].get("verifier_queue_peak"),
            "queue_wait_p50_ms": qw.get("p50_ms"), "queue_wait_p99_ms": qw.get("p99_ms"),
        })
    peak = max(range(n), key=lambda i: nodes[i]["peak_pressure"])
    level0 = [p["level0_s"] for p in nodes]
    # the arm net's own committed rate: over the arm (the first offer to
    # the last commit on every node), and while the crowd was admitted
    # (the burst's first offer to the last node's last crowd admission)
    commits = last_commits(traces)
    crowd_end = max((t_burst + p["crowd_admitted_s"][1] for p in nodes if p["crowd_admitted_s"]), default=None)
    arm_rate = commit_rate(commits, t_go, commits[-1]) if commits else None
    crowd_rate = commit_rate(commits, t_burst, crowd_end) if crowd_end is not None else None
    row = {
        "workload": workload, "arm": arm, "seed": plan["seed"], "nodes": n, "f": 1,
        "n_clients": len(keys), "crowd": plan["crowd"] if workload == "flash_crowd" else 1,
        "capacity_sigs_per_sec": plan["cap"], "capacity_sigs_per_sec_fleet": plan["cap"] * n,
        "offered": sum(offered_by_client), "offered_steady": sum(offered_by_client[c] for c in steady_ids),
        "committed": min(len(o) for o in commit_orders), "committed_steady": len(steady_lats),
        "shed": sum(shed), "shed_events": sum(shed_events),
        "steady_p50_ms": round(1e3 * _pctl(steady_lats, 0.50), 3), "steady_p99_ms": steady_p99,
        "all_p99_ms": round(1e3 * _pctl(all_lats, 0.99), 3),
        "fairness": fairness, "latency_slo_ms": slo_ms, "fairness_floor": AB_FAIRNESS_FLOOR,
        "slo_ok": bool(steady_lats) and steady_p99 <= slo_ms, "fairness_ok": fairness >= AB_FAIRNESS_FLOOR,
        "card": plan["card"], "c_tx": plan["c_tx"], "sigs_per_tx": plan["sigs_per_tx"],
        "kernel_launches": launches,
        "peak_level": nodes[peak]["peak_level"], "peak_signal": nodes[peak]["peak_signal"],
        "burn_end": max((p["burn_end"] for p in nodes if p["burn_end"] is not None), default=None),
        "level0_s": None if None in level0 else max(level0),
        "n_tx": len(events), "expected": n_expected, "parked": n_parked, "overdrawn": overdrawn,
        "acked": final["ack"], "refused": sum(v for k, v in final.items() if k != "ack"),
        "refusals": len(refusals), "retried_then_acked": len(retried),
        "shed_requests": shed_req, "stamped_on": stamped_on,
        "lateness_p50_s": _pctl(late, 0.50), "lateness_p99_s": lateness_p99, "lateness_max_s": late[-1],
        "sender_cpu_share": [cpu / (t_sent - t_go) for _, _, cpu in done],
        "sign_s": [r[1] for r in ready], "arm_s": t_settled - t_go, "nodes_detail": nodes,
        "directory_size": size, "steady_stages_ms": stages, "register_s": t_reg, "collect_s": collect_s,
        "arm_tx_per_s": arm_rate, "crowd_tx_per_s": crowd_rate,
        "queue_target": None if ov is None else ov.queue_target,
    }

    # a failed call is a shed (RESOURCE_EXHAUSTED) or a call the node's
    # gRPC server never handed to a handler, cancelled after grpc's
    # unrequested-call limit (CANCELLED); nothing else may fail
    waits: dict = {}
    for _, _, _, _, rs, starts in records:
        for r, t_start in zip(rs, starts):
            waits.setdefault(r[1], []).append(r[0] - t_start)
    cancelled = sorted(waits.get("CANCELLED", []))
    row["cancelled"] = len(cancelled)
    gate(set(waits) <= {"RESOURCE_EXHAUSTED", "CANCELLED"},
         f"calls failed otherwise than shed or cancelled unrequested: {sorted(set(waits))}")
    gate(not cancelled or cancelled[0] >= AB_UNREQUESTED_S,
         f"{sum(1 for w in cancelled if w < AB_UNREQUESTED_S)} calls CANCELLED sooner than {AB_UNREQUESTED_S} s "
         f"after they went out, e.g. {[round(w, 3) for w in cancelled[:4]]}")
    # (b) the uncontrolled arm never sheds
    if not controlled:
        n_shed = len(waits.get("RESOURCE_EXHAUSTED", []))
        gate(not n_shed and sum(shed_req) == 0 and row["shed"] == 0,
             f"{n_shed} refusals RESOURCE_EXHAUSTED, shed requests {shed_req}, entries {shed} without an "
             f"[overload] table")
        gate(all(not h[4] for i in range(n) for h in poll.health(i) if h[1] is not None)
             and all(s["pressure"]["pressure"] == 0 for s in status),
             "the controller's pressure moved without an [overload] table")
    # (c) the controlled flash crowd runs the shed path (the card's verifier
    # queue is what the controller reads; the host kind has none)
    codes = Counter(r[1] for _, r in refusals)
    bad_hints = sorted({r[2] for _, r in refusals if r[2] is None or not ov.retry_after_ms <= r[2] <=
                        ov.retry_after_max_ms}, key=str) if ov is not None else []
    everywhere = set.intersection(*({(r["sender"], r["seq"]) for r in d["completed"] if r["terminal"] == "committed"}
                                    for d in traces))
    retried_committed = [idx for idx in retried
                         if (hexes[events[idx][2]["client"]], events[idx][2]["seq"]) in everywhere]
    row["retried_then_committed"] = len(retried_committed)
    row["retries"], row["retries_before_hint"] = n_retries, len(early)
    # (c)'s third clause, a retried transfer committing, holds on the card
    # only sometimes (PERF.md section 6): a tracked strict check, printed
    # and kept in the row, not gated; once it holds in every run, it is to
    # be gated again
    row["strict_c3_held"] = bool(retried_committed) if controlled and workload == "flash_crowd" else None
    # how early the controller came: level 2 first read before the crowd's
    # last admission on every node (a tracked strict check, printed and
    # kept in the row, not gated), each node's margin in seconds beside it
    row["level2_margins_s"] = [p["level2_margin_s"] for p in nodes]
    row["strict_level2_held"] = (all(m is not None and m > 0 for m in row["level2_margins_s"])
                                 if controlled and workload == "flash_crowd" else None)
    if controlled and workload == "flash_crowd" and kind == "cuda":
        gate(sum(shed_req) >= 1, "no node shed a request: the shed path did not run (a node's crowd admitted "
             "from / until, and its level 2 first read, in s after the burst's first offer: "
             f"{[(p['crowd_admitted_s'], p['level2_s']) for p in nodes]})")
        gate(set(codes) <= {"RESOURCE_EXHAUSTED"}, f"refusals other than RESOURCE_EXHAUSTED: {dict(codes)}")
        gate(not bad_hints, f"refusal hints outside [{ov.retry_after_ms}, {ov.retry_after_max_ms}] ms: {bad_hints[:8]}")
        gate(n_retries > 0 and not early, f"RetryPolicy retried {n_retries} refusals, {len(early)} of them "
             f"sooner than {floor} x the hint, e.g. {early[:4]}")
    # (d) K1 runs on every node
    if kind == "cuda":
        gate(all(x > 0 for x in launches), f"K1 launches {launches}: not on every node")
    # (e) the senders keep to the schedule
    gate(lateness_p99 < AB_LATENESS_P99_S, f"send lateness p99 {lateness_p99:.3f} s (limit {AB_LATENESS_P99_S} s)")

    log(f"{label}: {len(events)} transfers offered over {max(t for t, _, _ in events):.2f} s "
        f"({row['offered_steady']} from the {len(steady_ids)} registered steady clients; directory_size {size}) "
        f"as unary SendAsset through RetryPolicy(budget={AB_RETRY_BUDGET}) from {len(senders.conns)} sender processes (signing "
        f"{max(row['sign_s']):.2f} s beforehand); send lateness p50 {1e3 * row['lateness_p50_s']:.1f} ms, p99 "
        f"{1e3 * lateness_p99:.1f} ms, max {1e3 * row['lateness_max_s']:.1f} ms; sender CPU "
        f"{[round(s, 3) for s in row['sender_cpu_share']]} of a core each")
    log(f"{label}: acknowledged {final['ack']}, finally refused {row['refused']} ({dict(final)}); refusals "
        f"{len(refusals)} ({dict(codes)}; seconds from the attempt, min / p50 / max: "
        f"{ {c: [round(_pctl(sorted(w), q), 3) for q in (0.0, 0.5, 1.0)] for c, w in waits.items()} }), "
        f"hints {sorted(Counter(r[2] for _, r in refusals).items(), key=str)[:6]}; "
        f"RetryPolicy retries {n_retries} ({len(early)} sooner than {floor} x the hint); retried then "
        f"acknowledged {len(retried)}, of them committed on every node {len(retried_committed)}; "
        f"expected {n_expected}, acknowledged behind a refused sequence (parked) {n_parked} from "
        f"{len(parked)} senders; debits failed for lack of balance a node {overdrawn}; ledgers equal to the "
        f"replay in each node's own commit order: {ledgers_ok}; arm {row['arm_s']:.1f} s from the first offer to the last "
        f"commit (registration {t_reg:.1f} s before it, the readings {collect_s:.1f} s after)")
    log(f"{label}: steady tier offered-to-commit (the latest of the {n} nodes' /tracez stamps, over "
        f"{len(steady_lats)} transfers stamped on all {n}; by nodes stamped {stamped_on}) p50 "
        f"{row['steady_p50_ms']:.1f} ms, p99 {steady_p99:.1f} ms, all transfers p99 {row['all_p99_ms']:.1f} ms; "
        f"latency_slo_ms {slo_ms:.0f}: slo_ok {row['slo_ok']}; fairness {fairness:.4f} (floor "
        f"{AB_FAIRNESS_FLOOR}): fairness_ok {row['fairness_ok']}; committed (fewest of a node) {row['committed']}; "
        f"the steady tier's time by segment (p50, p99 ms; the admitting node's stamps): {stages}")
    def strict(held) -> str:
        return "n/a (the controlled flash_crowd arm's)" if held is None else "held" if held else "MISSED"

    log(f"{label}: strict check (c) 3 (a transfer retried by RetryPolicy, then committed on every node): "
        f"{strict(row['strict_c3_held'])} ({len(retried_committed)} transfers; a known miss on the card, open in "
        f"ROADMAP section 3: printed, not gated); strict check, level 2 first read before the crowd's last "
        f"admission on every node: {strict(row['strict_level2_held'])} (the margin a node, s: "
        f"{row['level2_margins_s']}; printed, not gated)")
    log(f"{label}: the arm net's committed rate {rate_text(arm_rate)} over the arm, {rate_text(crowd_rate)} "
        f"while the crowd was admitted; C_tx {plan['c_tx']:,.1f} tx/s")
    for i, p in enumerate(nodes):
        log(f"{label} node {i}: overload_shed_requests {shed_req[i]}, shed entries {shed[i]}, recorder shed "
            f"events {shed_events[i]}; peak level {p['peak_level']}, peak pressure {p['peak_pressure']}, the "
            f"signal at the peak {p['peak_signal']} (readings each signal led {p['signal_led']}); burn at the "
            f"end {p['burn_end']}; level 0 {seconds_or_never(p['level0_s'])} after the schedule's last offer; "
            f"verifier queue peak {p['queue_peak']} (queue_target {row['queue_target']}), queue wait p50 "
            f"{p['queue_wait_p50_ms']} ms p99 {p['queue_wait_p99_ms']} ms; K1 launches {launches[i]}"
            + (f"; the crowd admitted from {p['crowd_admitted_s']} s after the burst's first offer, level 2 "
               f"first read {p['level2_s']} s after it (margin {p['level2_margin_s']} s), pressure first over "
               f"shed_start (s after the offer, the largest signal) {p['over_shed_start']}; readings from the "
               f"offer to the last admission (s, pressure, {'/'.join(AB_SIGNALS)}): {p['pressure_series']}"
               if crowd else ""))
    return row


async def ab_pair(nets: dict, senders: ABSenders, plan: dict, ov, kind: str, failures: list,
                  card_line: str) -> list:
    """A workload's two arms on its started pair of nets ({controlled:
    net}), uncontrolled first; the pair is stopped after them. Its two
    rows."""
    from at2_node_tpu_torch.node.config import Config
    from at2_node_tpu_torch.sim.scenarios import _OVERLOAD_WORKLOADS

    workload = plan["workload"]
    tune = _OVERLOAD_WORKLOADS[workload]
    pair = []
    try:
        for on, net in nets.items():
            for path in net.tomls:
                with open(path) as f:
                    got = Config.loads(f.read())
                check(got.overload == (ov if on else type(ov)()) and
                      got.observability.trace_done_cap == plan["trace_caps"][on] and
                      got.echo_threshold == got.ready_threshold == 2,
                      f"{path}: its [overload] table {got.overload} is not the arm's")
        for on in (False, True):
            pair.append(await ab_arm(nets[on], senders, {**plan, "table": ov if on else None}, on,
                                     kind, failures))
    finally:
        for net in nets.values():  # both nets shut down side by side
            net.terminate()
        rcs = [net.stop() for net in nets.values()]
    check(all(r == [0] * len(r) for r in rcs), f"overload A/B node nets (14, {workload}): servers "
          f"exited with {rcs} on SIGTERM")
    off, on_ = pair
    log(f"overload A/B (14, {workload}): the reference's bar (run_overload_ab's ok: the uncontrolled arm "
        f"breaches latency_slo_ms {tune['latency_slo_ms']:.0f}, the controlled arm holds it with fairness "
        f">= {AB_FAIRNESS_FLOOR}): uncontrolled steady p99 {off['steady_p99_ms']:.1f} ms: "
        f"{'held' if not off['slo_ok'] else 'MISSED'}; controlled steady p99 {on_['steady_p99_ms']:.1f} "
        f"ms, fairness {on_['fairness']:.4f}: {'held' if on_['slo_ok'] and on_['fairness_ok'] else 'MISSED'}"
        f"; shed {off['shed']} / {on_['shed']} entries; {card_line}")
    return pair


async def overload_ab_path(seed: int, card_line: str, kind: str = "cuda", c_tx: float | None = None,
                           n_clients: int = AB_CLIENTS, crowd: int = AB_CROWD, duration: float = AB_DURATION_S,
                           out_dir: str | None = None) -> dict:
    """Phase 14: the reference's overload A/B bench on four served nodes
    a net, a pair of nets a workload (uncontrolled: no ``[overload]``
    table; controlled: ``overload_objectives(cap)``, cap the per-node
    verify rate at C_tx), the same schedule on each. Unless ``c_tx`` is
    given, flash_crowd's uncontrolled net starts first and C_tx is
    ``measure_intake`` on it. Then the other nets start together, and
    every net stays up until its pair's arms are over. A row a cell goes
    to ``out_dir`` (``tools/_common.OUT_DIR`` by default). A failed gate
    fails the phase once all four cells printed."""
    import tempfile

    from at2_node_tpu_torch.sim.net import sim_client
    from at2_node_tpu_torch.sim.scenarios import _OVERLOAD_SIGS_PER_TX, _OVERLOAD_WORKLOADS, overload_objectives
    from at2_node_tpu_torch.tools._common import OUT_DIR, card_stamp

    t14 = time.perf_counter()
    stamp = card_stamp("cuda:0" if kind == "cuda" else "cpu")
    rows, failures, intake = [], [], None

    def caps(rate: float) -> dict:
        """The reference cell's trace, done and recorder caps, max(4096,
        4 n_tx), at each workload's n_tx for ``rate``."""
        return {w: max(4096, 4 * ab_n_tx(rate, _OVERLOAD_WORKLOADS[w]["capacity_frac"], duration * AB_DEPTH[w]))
                for w in AB_WORKLOADS}

    senders = ABSenders()
    try:
        with tempfile.TemporaryDirectory(prefix="at2-phase14-") as workdir:
            def net_of(workload: str, ov, trace_cap: int):
                name = f"{workload}-{'on' if ov is not None else 'off'}"
                return ab_net(kind, os.path.join(workdir, name), ov, trace_cap)

            pairs = {w: {} for w in AB_WORKLOADS}
            every = []
            try:
                if c_tx is None:
                    # the measured net starts before C_tx is known: its caps
                    # hold the measurement and a cell at the offered rate
                    bound = caps(INTAKE_RATE)["flash_crowd"]
                    measured = pairs["flash_crowd"][False] = net_of("flash_crowd", None, bound)
                    every.append(measured)
                    start_pair([measured], "overload A/B node net (14, flash_crowd, uncontrolled)")
                    intake = await measure_intake(measured, senders, seed, crowd, duration, bound,
                                                  "overload A/B intake (14, flash_crowd, the uncontrolled net)")
                    c_tx, sigs_per_tx = intake["tx_per_s"], intake["sigs_per_tx"]
                else:
                    sigs_per_tx = _OVERLOAD_SIGS_PER_TX
                cap = c_tx * sigs_per_tx / NET_NODES
                ov = overload_objectives(cap)
                log(f"overload A/B (14): C_tx {c_tx:,.1f} tx/s "
                    f"({'measured on the flash_crowd uncontrolled net' if intake else 'given'}), {sigs_per_tx:.2f} "
                    f"signatures a transfer ({'measured' if intake else 'the reference'}; the reference models "
                    f"{_OVERLOAD_SIGS_PER_TX:.0f}): the controlled arms' cap {cap:,.1f} sigs/s a node (each node's "
                    f"controller reads its own verifier), {cap * NET_NODES:,.1f} for the fleet; "
                    f"overload_objectives(cap): queue_target {ov.queue_target}, sample_interval "
                    f"{ov.sample_interval}, smoothing {ov.smoothing}, sojourn_target_ms {ov.sojourn_target_ms}, "
                    f"retry_after_ms [{ov.retry_after_ms}, {ov.retry_after_max_ms}]")
                plans, trace_caps = {}, caps(c_tx)
                arm_caps = {w: {on: bound if on in pairs[w] else trace_caps[w] for on in (False, True)}
                            for w in AB_WORKLOADS}
                for workload in AB_WORKLOADS:
                    tune = _OVERLOAD_WORKLOADS[workload]
                    run_s = duration * AB_DEPTH[workload]
                    n_tx = ab_n_tx(c_tx, tune["capacity_frac"], run_s)
                    plans[workload] = {
                        "seed": seed, "workload": workload, "crowd": crowd, "cap": cap, "c_tx": c_tx,
                        "sigs_per_tx": sigs_per_tx, "card": stamp, "latency_slo_ms": tune["latency_slo_ms"],
                        "trace_caps": arm_caps[workload], "keys": [sim_client(seed, i) for i in range(n_clients)],
                        "events": ab_schedule(seed, workload, NET_NODES, n_clients, crowd, n_tx, run_s),
                        "steady_ids": ab_steady_ids(workload, n_clients, crowd)}
                    log(f"overload A/B (14, {workload}): n_tx {n_tx} = round({run_s:g} s x C_tx / capacity_frac "
                        f"{tune['capacity_frac']}), {n_clients} clients ({len(plans[workload]['steady_ids'])} "
                        f"steady), latency_slo_ms {tune['latency_slo_ms']:.0f}; trace and recorder caps "
                        f"{trace_caps[workload]}"
                        + (f" ({bound} on the measured net)" if False in pairs[workload] else ""))
                rest = [(w, on) for w in AB_WORKLOADS for on in (False, True) if on not in pairs[w]]
                for w, on in rest:
                    pairs[w][on] = net_of(w, ov if on else None, arm_caps[w][on])
                every += [pairs[w][on] for w, on in rest]
                start_pair([pairs[w][on] for w, on in rest], "overload A/B node nets (14, " + ", ".join(
                    f"{w} {'controlled' if on else 'uncontrolled'}" for w, on in rest) + ")")
                for workload in AB_WORKLOADS:
                    rows += await ab_pair(pairs[workload], senders, plans[workload], ov, kind, failures,
                                          card_line)
            finally:
                for net in every:  # a net already stopped is left as it is
                    net.stop()
    finally:
        senders.close()
    bars = {w: (not r[0]["slo_ok"]) and r[1]["slo_ok"] and r[1]["fairness_ok"]
            for w, r in zip(AB_WORKLOADS, zip(rows[0::2], rows[1::2]))}
    doc = {"bench": "overload_ab_served", "seed": seed, "card": stamp, "intake": intake, "cells": rows,
           "bars": bars, "ok": all(bars.values())}
    os.makedirs(out_dir or OUT_DIR, exist_ok=True)
    path = os.path.join(out_dir or OUT_DIR, "overload_ab_served.json")
    write_json(path, doc)
    seconds = time.perf_counter() - t14
    c3 = [r["strict_c3_held"] for r in rows if r["strict_c3_held"] is not None]
    l2 = [r for r in rows if r["strict_level2_held"] is not None]
    log(f"overload A/B (14): {len(rows)} rows written to {path}; the reference's bar: "
        + ", ".join(f"{w} {'held' if ok else 'MISSED'}" for w, ok in bars.items())
        + f" (printed, not gated on); strict check (c) 3: {'held' if all(c3) else 'MISSED'}; strict check, level 2 "
        f"before the crowd's last admission on every node: "
        f"{'held' if all(r['strict_level2_held'] for r in l2) else 'MISSED'}"
        f" (margins, s: {[r['level2_margins_s'] for r in l2]}); phase 14 took "
        f"{seconds:.1f} s; {card_line}")
    check(not failures, "phase 14: " + "; ".join(failures))
    return {"rows": rows, "bars": bars, "intake": intake, "path": path, "seconds": seconds,
            "launches": sum(sum(r["kernel_launches"]) for r in rows) + (sum(intake["launches"]) if intake else 0)}


# -- phase 15 --------------------------------------------------------------


WAN_REGIONS = ("eu", "eu", "us", "us")  # node i's [wan] region and the hint on its [[nodes]] entries
WAN_PACED_CLIENTS = 16  # registered clients, a unary SendAsset each every WAN_PACED_PERIOD_S
WAN_PACED_PERIOD_S = 0.1
WAN_PACED_S = 3.0  # cut from 8 s to keep a call under 700 s
WAN_BROKER_CLIENTS = 4  # loadgen --broker: lone transfers through the broker
WAN_BROKER_PER = 16
WAN_BURST_CLIENTS = 16  # one SendAssetBatch burst a client
WAN_BURST_PER = 128  # cut from 256
WAN_TAIL_PER = 128  # 15b: transfers a burst client commits on nodes 0-2 while node 3 is down (cut from 256)
# every transfer of an arm stays on /tracez, where the paced tier's and the
# broker tier's commit stamps are read
WAN_TRACE_CAP = 16384
REJOIN_NODE = 3  # 15b: the node with [checkpoint] that stops and rejoins
REJOIN_CHECKPOINT_S = 1.0  # its [checkpoint] interval
REJOIN_CATCHUP = "[catchup]\nafter = 0.5\nwindow = 1.0\n"  # its catch-up: a session within ~1.5 s
REJOIN_LIVE_S = 120.0
FILLER_CHUNK = 256  # 15b: Register calls in flight a survivor while its queue to node 3 is pushed out
MEMBERSHIP_GRACE_S = 1.0  # 15c: [membership] grace
MEMBERSHIP_CLIENTS = 8  # 15c: clients, each MEMBERSHIP_PER transfers a round (three rounds)
MEMBERSHIP_PER = 16


def wan_plan(seed: int, paced: int, broker: int, burst: int) -> dict:
    """Both arms' keys and transfers, from ``seed``: the paced tier's keys
    and each one's registration transfer, the broker tier's loadgen seed,
    the burst's keys and transfers."""
    from at2_node_tpu_torch.crypto.keys import SignKeyPair

    rng = np.random.default_rng(seed + 15)
    keys = [SignKeyPair(rng.bytes(32)) for _ in range(paced)]
    burst_keys = [SignKeyPair(rng.bytes(32)) for _ in range(burst)]
    return {"seed": seed, "paced": keys,
            "seeds": [(keys[(c + 1) % paced].public, int(rng.integers(1, 51))) for c in range(paced)],
            "broker_seed": seed + 1500, "broker_clients": broker, "burst": burst_keys, "rng": rng}


def wan_net(on: bool, kind: str, workdir: str) -> ServerNet:
    """An arm's four ``server run`` nodes at thresholds of two peers (f =
    1), the region hints on every ``[[nodes]]`` entry, the trace caps, node
    REJOIN_NODE with ``[checkpoint]`` and a short ``[catchup]``; arm on with
    the four ``[wan]`` levers and each node's own region."""
    os.makedirs(workdir)
    checkpoint = os.path.join(workdir, f"node{REJOIN_NODE}.ckpt")

    def tables(i: int) -> str:
        text = f"[observability]\ntrace_cap = {WAN_TRACE_CAP}\ntrace_done_cap = {WAN_TRACE_CAP}\n"
        if on:
            text += (f'\n[wan]\noverlap_ready = true\nregion_fanout = true\nregion = "{WAN_REGIONS[i]}"\n'
                     "verify_ahead = true\neager_broker = true\n")
        if i == REJOIN_NODE:
            text += f'\n[checkpoint]\npath = "{checkpoint}"\ninterval = {REJOIN_CHECKPOINT_S}\n\n{REJOIN_CATCHUP}'
        return text

    net = ServerNet(kind, workdir, top=AB_THRESHOLDS, tables=tables, regions=WAN_REGIONS)
    net.checkpoint = checkpoint
    return net


def piggybacked(capture: dict) -> tuple:
    """A ``/capturez`` dump's frames decoded with ``messages.parse_frame``:
    how many hold an Echo, and how many hold an Echo and a Ready of one
    slot and one content from one origin (the per-transaction ECHO and
    READY, or the batched BATCH_ECHO and BATCH_READY)."""
    from at2_node_tpu_torch.broadcast.messages import (
        BATCH_ECHO, ECHO, READY, Attestation, BatchAttestation, parse_frame)

    echo_frames = carried = 0
    for rec in capture["records"]:
        echoes, readies = set(), set()
        for m in parse_frame(bytes.fromhex(rec[3])):
            if isinstance(m, Attestation) and m.phase in (ECHO, READY):
                (echoes if m.phase == ECHO else readies).add((m.origin, m.sender, m.sequence, m.content_hash))
            elif isinstance(m, BatchAttestation):
                (echoes if m.phase == BATCH_ECHO else readies).add(
                    (m.origin, m.batch_origin, m.batch_seq, m.batch_hash))
        echo_frames += bool(echoes)
        carried += bool(echoes & readies)
    return echo_frames, carried


async def wan_drive(net: ServerNet, broker: str, plan: dict, label: str, paced_s: float,
                    broker_per: int, burst_per: int) -> dict:
    """An arm's three tiers on its started net, ``/healthz`` and the
    pressure block polled throughout: the paced tier registers, then each
    of its clients sends a unary ``SendAsset`` every WAN_PACED_PERIOD_S for
    ``paced_s``, round-robin over the nodes, and node 0's ``/capturez`` is
    read; then lone transfers through the broker (``loadgen --broker``);
    then one ``SendAssetBatch`` burst a client, client c to node c mod n.
    Every tier's transfers commit on every node before the next begins."""
    from at2_node_tpu_torch.client import Client
    from at2_node_tpu_torch.tools import loadgen

    n, keys, seed = net.n, plan["paced"], plan["seed"]
    run = {"status0": [net.statusz(i) for i in range(n)], "acks": [[] for _ in keys], "broker_per": broker_per}
    clients = [Client(f"http://127.0.0.1:{p}") for p in net.rpc_ports]

    async def paced(c: int, t0: float) -> None:
        kp, prng, acks = keys[c], np.random.default_rng([seed, 15, c]), run["acks"][c]
        k = 0
        while (t_k := t0 + (k + c / len(keys)) * WAN_PACED_PERIOD_S) < t0 + paced_s:
            await asyncio.sleep(max(0.0, t_k - time.monotonic()))
            recipient = keys[(c + 1 + int(prng.integers(0, len(keys) - 1))) % len(keys)].public
            amount = int(prng.integers(1, 51))
            await clients[(c + k) % n].send_asset(kp, k + 2, recipient, amount)
            acks.append((k + 2, recipient, amount, time.monotonic()))
            k += 1

    try:
        with Poller(net) as poll:
            t0 = time.monotonic()
            await register_steady(net, clients, keys, plan["seeds"], label)
            before = [net.committed(i) for i in range(n)]
            t_paced = time.monotonic()
            await asyncio.gather(*(paced(c, t_paced) for c in range(len(keys))))
            n_paced = sum(map(len, run["acks"]))
            wait_committed(net, [b + n_paced for b in before], NET_DEADLINE_S)
            run["capture"] = json.loads(net.get(0, "/capturez"))

            before = [net.committed(i) for i in range(n)]
            t_b = time.perf_counter()
            load = await loadgen.run_load([f"http://{broker}"], clients=plan["broker_clients"],
                                          tx_per_client=broker_per, broker=True, seed=plan["broker_seed"],
                                          commit_timeout=NET_DEADLINE_S)
            n_broker = plan["broker_clients"] * broker_per
            check(load.submitted == load.committed == n_broker,
                  f"{label}: loadgen --broker submitted {load.submitted}, committed {load.committed} of {n_broker}")
            run["broker_s"] = wait_committed(net, [b + n_broker for b in before], NET_DEADLINE_S) - t_b

            rng = np.random.default_rng(seed + 1501)
            run["burst_transfers"] = more_transfers(rng, plan["burst"], 1, burst_per)
            run["burst"] = await node_run(net, label, plan["burst"], run["burst_transfers"], True, {},
                                          burst_per, NET_DEADLINE_S)
            t_poll_end = time.monotonic()
    finally:
        for cl in clients:
            await cl.close()
    run.update(poll=poll, t0=t0, t_poll_end=t_poll_end, n_paced=n_paced, n_broker=n_broker)
    return run


async def wan_collect(net: ServerNet, broker: str, run: dict, plan: dict, kind: str, on: bool,
                      card_line: str, failures: list) -> dict:
    """Right after an arm's tiers, its net still up: the ledgers against
    the replay, every node's ``/statusz``, the nodes' and the broker's
    ``/tracez``, the broker's ``/statusz``; the arm's readings printed and
    its failed gates appended to ``failures``."""
    from at2_node_tpu_torch.tools import loadgen
    from at2_node_tpu_torch.tools.trace_collect import _pctl, phase_overlap, stitch

    n, keys = net.n, plan["paced"]
    label = f"wan node net (15a, arm {'on' if on else 'off'})"

    def gate(cond: bool, what: str) -> None:
        if not cond:
            failures.append(f"{label}: {what}")

    broker_keys = loadgen.client_keys(plan["broker_clients"], plan["broker_seed"])
    per_broker = run["broker_per"]
    await check_replay(net, keys, [[(1, *plan["seeds"][c])] + [a[:3] for a in run["acks"][c]]
                                   for c in range(len(keys))])
    await check_replay(net, broker_keys, [[(s, kp.public, 1) for s in range(1, per_broker + 1)]
                                          for kp in broker_keys])
    await check_replay(net, plan["burst"], run["burst_transfers"])
    with ThreadPoolExecutor(max_workers=n) as pool:
        status = list(pool.map(net.statusz, range(n)))
        traces = list(pool.map(lambda i: json.loads(net.get(i, f"/tracez?limit={WAN_TRACE_CAP}")), range(n)))
    bstat = http_json(broker, "/statusz")["stats"]
    btrace = http_json(broker, f"/tracez?limit={WAN_TRACE_CAP}")

    lats, stamped_on, short = steady_latencies(traces, keys, run["acks"])
    gate(not short and bool(lats), f"{len(short)} of {run['n_paced']} paced transfers lack a commit stamp on "
         f"some node's /tracez (transfers by the number of nodes that stamped them: {stamped_on})")
    ms = lambda xs, q: 1e3 * _pctl(sorted(xs), q) if xs else float("nan")  # noqa: E731
    rx = {(r["sender"], r["seq"]): mono for r in btrace["completed"] + btrace["live"]
          for stage, mono, _ in r["stages"] if stage == "broker_rx"}
    want = {(kp.public.hex(), s) for kp in broker_keys for s in range(1, per_broker + 1)}
    _, b_lats, b_stamped = ab_latencies(traces, {k: t for k, t in rx.items() if k in want}, set())
    gate(len(b_lats) == len(want), f"{len(want) - len(b_lats)} of {len(want)} broker transfers lack a broker_rx "
         f"stamp or a commit stamp on some node (by the number of nodes: {b_stamped})")

    # the piggyback on the wire (frames that carry an Echo with its Ready)
    # and in the nodes' phase markers (a Ready sent before its echo
    # quorum: trace_collect's negative echo->ready gap); both arms' are
    # compared once both have run (wan_served_path)
    echo_frames, carried = piggybacked(run["capture"])
    records = len(run["capture"]["records"])
    overlap = phase_overlap(stitch(traces))
    early = overlap["piggybacked"]
    eager = bstat["broker_eager_flushes"]
    gate(eager > 0 if on else eager == 0, f"broker_eager_flushes {eager}")

    t0, t_end, poll = run["t0"], run["t_poll_end"], run["poll"]
    nodes = []
    for i in range(n):
        health = [h for h in poll.health(i) if t0 <= h[0] <= t_end]
        unanswered = sum(1 for h in health if h[1] is None)
        not_ok = [h for h in health if h[1] is not None and (h[1] != 200 or h[2] != "ok")]
        slo_only = [h for h in not_ok if slo_breach(h)]
        gate(health and not unanswered, f"node {i}: {unanswered} of {len(health)} /healthz polls unanswered")
        gate(len(slo_only) == len(not_ok), f"node {i}: /healthz answered {len(not_ok) - len(slo_only)} polls "
             f"otherwise than 200 ok or 503 for an SLO breach: "
             f"{dict(Counter((h[1], h[5]) for h in not_ok if h not in slo_only))}")
        launches = status[i]["build"]["kernel_launches"] - run["status0"][i]["build"]["kernel_launches"]
        if kind == "cuda":
            gate(launches > 0, f"node {i}: the verify kernel never launched")
        nodes.append({"launches": launches, "healthz_polls": len(health),
                      "healthz_not_ok": dict(Counter(h[5] for h in not_ok)),
                      "queue_peak": status[i]["stats"].get("verifier_queue_peak")})
    burst = run["burst"]
    out = {
        "arm": "on" if on else "off", "paced_p50_ms": ms(lats, 0.50), "paced_p99_ms": ms(lats, 0.99),
        "paced_committed": run["n_paced"], "broker_p50_ms": ms(b_lats, 0.50), "broker_p99_ms": ms(b_lats, 0.99),
        "broker_committed": run["n_broker"], "broker_s": run["broker_s"], "burst_tx_per_s": burst["tx_per_s"],
        "burst_committed": burst["transfers"], "capture_records": records, "echo_frames": echo_frames,
        "echo_ready_frames": carried, "ready_before_echo_quorum": early, "overlap_spans": overlap["spans"],
        "overlap_gap_p50_ms": overlap["gap_p50_ms"], "broker_eager_flushes": eager,
        "broker_flushes": bstat.get("broker_batches_tx"), "nodes": nodes,
        "launches": sum(p["launches"] for p in nodes),
    }
    log(f"{label}: paced tier {len(keys)} clients, {run['n_paced']} unary transfers committed on all {n} nodes; "
        f"acknowledgement to commit on every node (the latest of the {n} nodes' /tracez stamps) p50 "
        f"{out['paced_p50_ms']:.1f} ms, p99 {out['paced_p99_ms']:.1f} ms; broker tier "
        f"{plan['broker_clients']} x {per_broker} lone transfers (loadgen --broker"
        + (", the broker with --eager" if on else "") + f"): broker_rx to the last node's commit p50 "
        f"{out['broker_p50_ms']:.1f} ms, p99 {out['broker_p99_ms']:.1f} ms, broker_eager_flushes {eager} of "
        f"{out['broker_flushes']} frames; burst {len(plan['burst'])} x {len(run['burst_transfers'][0])} "
        f"(SendAssetBatch) {burst['tx_per_s']:,.0f} tx/s committed; node 0's /capturez: {carried} of "
        f"{records} frames carry an Echo with its Ready ({echo_frames} hold an Echo); the nodes' phase markers: "
        f"{early} of {overlap['spans']} (transfer, node) spans sent the Ready before the echo quorum, "
        f"echo->ready gap p50 {overlap['gap_p50_ms']:.3f} ms, min {overlap['gap_min_ms']:.3f} ms; verify kernel launches a "
        f"node {[p['launches'] for p in nodes]}; /healthz answers other than 200 ok "
        f"{[p['healthz_not_ok'] or 'none' for p in nodes]}; every ledger equal to the replay; {card_line}")
    return out


def rejoin_frontier(path: str) -> dict:
    """The accounts of node REJOIN_NODE's ``[checkpoint]`` snapshot
    (hex key -> [sequence, balance]); empty while it has none."""
    try:
        with open(path) as f:
            return json.load(f).get("accounts", {})
    except (FileNotFoundError, json.JSONDecodeError):
        return {}


async def reannounce(net: ServerNet, survivors: list, keys: dict, chunk: int, done, label: str) -> dict:
    """A client at each survivor i re-registers ``keys[i]``, a key node i
    assigned (free, and one DirectoryAnnounce to every peer a call), in
    ``chunk`` calls at a time until ``done(stats at the start, stats
    now)`` holds for node i's ``/statusz`` stats; the calls a survivor."""
    import grpc

    from at2_node_tpu_torch.proto import at2_pb2 as pb
    from at2_node_tpu_torch.proto.rpc import At2Stub

    calls = {}

    async def one(i: int) -> None:
        st0, n = net.stats(i), 0
        req = pb.RegisterRequest(public_key=keys[i].public)
        async with grpc.aio.insecure_channel(f"127.0.0.1:{net.rpc_ports[i]}") as channel:
            stub = At2Stub(channel)
            t_end = time.perf_counter() + 120.0
            while not done(st0, st := net.stats(i)):
                check(time.perf_counter() < t_end, f"{label}: node {i} still short after {n} Register calls "
                      f"(its mesh at the start / now: " + ", ".join(
                          f"{k} {st0[k]} / {st[k]}" for k in ("mesh_redials", "mesh_dial_failures",
                                                             "mesh_send_overflows", "mesh_send_queue_depth")) + ")")
                await asyncio.gather(*(stub.Register(req) for _ in range(chunk)))
                n += chunk
                await asyncio.sleep(0.01)
        calls[i] = n

    await asyncio.gather(*(one(i) for i in survivors))
    return calls


async def rejoin_run(net: ServerNet, plan: dict, burst_transfers: list, paced_per_client: list,
                     broker_per: int, kind: str, card_line: str, tail_per: int) -> dict:
    """15b, on arm on's net once 15a is over: node REJOIN_NODE stops
    (SIGTERM: its final snapshot), the burst's clients commit ``tail_per``
    more each on the other three, what the survivors hold to send it is
    pushed out (``reannounce``), and it restarts from the same TOML: it
    loads its snapshot and must catch up the tail through catch-up, with
    ``verify_ahead`` checking the caught-up payloads on its verifier."""
    import signal

    from at2_node_tpu_torch.client import Client
    from at2_node_tpu_torch.crypto.keys import SignKeyPair
    from at2_node_tpu_torch.tools import loadgen

    n, r = net.n, REJOIN_NODE
    survivors = [i for i in range(n) if i != r]
    label = f"wan node net (15b, node {r} rejoins from its [checkpoint])"
    keys = plan["burst"]
    broker_keys = loadgen.client_keys(plan["broker_clients"], plan["broker_seed"])
    everyone = plan["paced"] + broker_keys + keys
    history = (paced_per_client + [[(s, kp.public, 1) for s in range(1, broker_per + 1)] for kp in broker_keys]
               + burst_transfers)
    replay = replay_ledger([(kp.public, *t) for kp, ts in zip(everyone, history) for t in ts])
    t_end = time.perf_counter() + 30.0
    while not rejoin_frontier(net.checkpoint):
        check(time.perf_counter() < t_end, f"{label}: node {r}'s snapshot holds no frontier after 30 s")
        time.sleep(0.1)
    net.procs[r].send_signal(signal.SIGTERM)
    rc = net.procs[r].wait(timeout=60)
    check(rc == 0, f"{label}: node {r} exited with {rc} on SIGTERM")
    snap = rejoin_frontier(net.checkpoint)
    check(snap == replay, f"{label}: node {r}'s snapshot at its stop differs from the replay of what 15a "
          f"committed ({len(snap)} accounts, the replay {len(replay)})")

    # While node r is down each survivor's mesh queues what it sends r
    # (net/peers.py: SEND_QUEUE_CAP messages, the oldest dropped first)
    # and replays it on redial, as after a short absence; so does the
    # batch its sender held when a send to r first failed. Directory
    # announcements fill both instead: first until every survivor's
    # sender to r is down (``mesh_redials`` grew: a send failed; or
    # ``mesh_dial_failures`` grew: a sender that had failed before, while
    # r stopped, cannot dial it), then, after the
    # tail, until its mesh has dropped as many messages as its queues
    # held. Then nothing of the tail is left to replay, as after a long
    # absence, and the tail reaches r only through catch-up.
    filler = {i: SignKeyPair(plan["rng"].bytes(32)) for i in survivors}
    await reannounce(net, survivors, filler, 4, lambda st0, st: st["mesh_redials"] > st0["mesh_redials"]
                     or st["mesh_dial_failures"] > st0["mesh_dial_failures"], label)
    tail = more_transfers(plan["rng"], keys, len(burst_transfers[0]) + 1, tail_per)
    n_tail = sum(map(len, tail))
    before = {i: net.committed(i) for i in survivors}
    t_tail = time.perf_counter()
    await send_batched(net, keys, tail, lambda c: survivors[c % len(survivors)])
    wait_committed(net, [before.get(i, 0) + n_tail for i in range(n)], NET_DEADLINE_S, nodes=survivors)
    tail_s = time.perf_counter() - t_tail
    held = {i: net.stats(i) for i in survivors}
    calls = await reannounce(
        net, survivors, filler, FILLER_CHUNK,
        lambda st0, st: st["mesh_send_overflows"] - st0["mesh_send_overflows"] >= max(st0["mesh_send_queue_depth"], 1),
        label)
    pushed = {i: {"held": held[i]["mesh_send_queue_depth"], "register_calls": calls[i],
                  "dropped": net.stats(i)["mesh_send_overflows"] - held[i]["mesh_send_overflows"]}
              for i in survivors}

    t_restart = time.perf_counter()
    net.restart(r)
    net.wait_rpc(r, t_restart + 180.0)
    rpc_s = time.perf_counter() - t_restart
    up = net.statusz(r)
    states, depths = [], []
    while True:
        status = net.statusz(r)
        rec = status["recovery"]
        if not states or states[-1] != rec["state"]:
            states.append(rec["state"])
        depths.append(status["stats"].get("verifier_queue_depth", 0))
        if rec["state"] == "live":
            break
        check(time.perf_counter() - t_restart < REJOIN_LIVE_S,
              f"{label}: node {r} not live {REJOIN_LIVE_S:.0f} s after its restart: {rec}")
        await asyncio.sleep(0.05)
    live_s = time.perf_counter() - t_restart
    want_seq = len(burst_transfers[0]) + tail_per
    async with Client(f"http://127.0.0.1:{net.rpc_ports[r]}") as conn:
        seqs = await asyncio.gather(*(conn.get_last_sequence(kp.public) for kp in keys))
    short_at_live = sum(s != want_seq for s in seqs)
    nudge = [[] for _ in keys]
    if short_at_live:
        # the reference's catch-up runner ends after a session whose peers
        # answered, reported the node behind, and whose history missed its
        # quorum in the window (fewer peers had redialed it than the
        # quorum): the node is live with nothing left to catch it up
        # (ROADMAP section 3; the port keeps the runner, which the sim's
        # pinned hashes replay). A later transfer of each tail sender
        # parks on its sequence gate and kicks a new catch-up, as traffic
        # would; it commits after the tail
        nudge = more_transfers(plan["rng"], keys, want_seq + 1, 1)
        await send_batched(net, keys, nudge, lambda c: c % n)
        want_seq += 1
    caught_s = await wait_sequences(net, r, keys, want_seq, NET_DEADLINE_S)
    for i in survivors:
        await wait_sequences(net, i, keys, want_seq, NET_DEADLINE_S)
    status = net.statusz(r)
    st = status["stats"]
    applied, pre = st["catchup_applied"], st["catchup_preverified"]
    launches = status["build"]["kernel_launches"] - up["build"]["kernel_launches"]
    n_nudge = sum(map(len, nudge))
    check("cold" not in states, f"{label}: node {r} restarted from its snapshot reported recovery states {states}")
    # every transfer node r missed came by catch-up, each counted once; a
    # nudge can come by catch-up too when its own delivery lands later
    check(n_tail <= applied <= n_tail + n_nudge,
          f"{label}: node {r} applied {applied} payloads by catch-up; it missed {n_tail} (+ {n_nudge} nudges)")
    check(pre > 0, f"{label}: node {r} pre-verified no caught-up payload (verify_ahead did not run)")
    check(kind != "cuda" or launches > 0, f"{label}: node {r}'s verify kernel did not launch while it caught up")
    full = [t + more + extra for t, more, extra in zip(burst_transfers, tail, nudge)]
    await check_replay(net, everyone, history[:-len(keys)] + full)
    skipped = sum(1 for d in depths if d)
    log(f"{label}: node {r} stopped with its snapshot equal to the replay ({len(snap)} accounts); the other "
        f"{len(survivors)} committed {n_tail} more transfers ({len(keys)} x {tail_per}, SendAssetBatch) in "
        f"{tail_s:.3f} s; what they held to send node {r} pushed out by re-registrations (a survivor: Register "
        f"calls {[pushed[i]['register_calls'] for i in survivors]}, messages dropped "
        f"{[pushed[i]['dropped'] for i in survivors]} of {[pushed[i]['held'] for i in survivors]} held)")
    log(f"{label}: node {r} restarted from the same TOML: RPC up {rpc_s:.3f} s after start, recovery states "
        f"{' -> '.join(states)}, live {live_s:.3f} s after start with {short_at_live} of {len(keys)} tail senders "
        f"short (strict check, live only once caught up: {'MISSED' if short_at_live else 'held'}; printed, not "
        f"gated: the reference's catch-up runner, ROADMAP section 3)"
        + (", then one more transfer of each tail sender to every node" if short_at_live else "")
        + f"; every tail sender at sequence {want_seq} {caught_s:.3f} s after live; catchup_applied {applied} "
        f"(the {n_tail} it missed), catchup_preverified {pre} ({pre / applied:.2f} x the applied: a payload "
        f"counts in each session that checked it), "
        f"catchup sessions {st['catchup_sessions']}; the verifier's queue_depth read nonzero in {skipped} of "
        f"{len(depths)} /statusz polls while it caught up (the node counts no skipped verify_ahead slice); verify "
        f"kernel launches since its RPC came up {launches}; every node's ledger equal to the replay; {card_line}")
    return {"tail": n_tail, "rpc_up_s": rpc_s, "live_s": live_s, "states": states, "catchup_s": caught_s,
            "short_at_live": short_at_live, "strict_live_held": not short_at_live, "nudges": n_nudge,
            "catchup_applied": applied, "catchup_preverified": pre, "catchup_sessions": st["catchup_sessions"],
            "queue_nonzero_polls": skipped, "polls": len(depths), "launches": launches,
            "pushed_out": {str(i): v for i, v in pushed.items()}}


async def wan_served_path(seed: int, card_line: str, kind: str, paced_s: float, broker_per: int,
                          burst_per: int, tail_per: int) -> dict:
    """15a and 15b: arm off and arm on, each on a net of its own started
    together, a broker in front of each node 0 (arm on's with
    ``--eager``); the arms one after the other, then 15b on arm on's net.
    A failed gate of 15a fails the phase once both arms have printed."""
    import signal
    import tempfile

    plan = wan_plan(seed, WAN_PACED_CLIENTS, WAN_BROKER_CLIENTS, WAN_BURST_CLIENTS)
    arms, failures, rcs, brcs = {}, [], {}, {}
    with tempfile.TemporaryDirectory(prefix="at2-phase15-") as workdir:
        nets = {on: wan_net(on, kind, os.path.join(workdir, "on" if on else "off")) for on in (False, True)}
        brokers: dict = {}

        def stop(on: bool) -> None:
            if on in brokers:
                proc = brokers[on][1]
                proc.send_signal(signal.SIGINT)
                try:
                    brcs[on] = proc.wait(timeout=60)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    brcs[on] = proc.wait()
            rcs[on] = nets[on].stop()

        try:
            start_pair([nets[False], nets[True]], "wan node net (15a)")
            for on in (False, True):
                brokers[on] = start_broker(nets[on], nets[on].workdir, eager=on)
            runs = {}
            for on in (False, True):
                label = f"wan node net (15a, arm {'on' if on else 'off'})"
                log(f"{label}: {NET_NODES} `server run` processes, [verifier] kind = \"{kind}\", thresholds of "
                    f"two peers, region hints {list(WAN_REGIONS)} on the [[nodes]] entries, "
                    + ("[wan] overlap_ready, region_fanout, verify_ahead, eager_broker on, each node's own "
                       "region; the broker with --eager" if on else "no [wan] table; the broker without --eager"))
                runs[on] = await wan_drive(nets[on], brokers[on][0], plan, label, paced_s, broker_per, burst_per)
                arms["on" if on else "off"] = await wan_collect(nets[on], brokers[on][0], runs[on], plan, kind, on,
                                                                 card_line, failures)
            stop(False)
            off, on_ = arms["off"], arms["on"]
            # overlap_ready on the wire and in the phase markers. Arm off
            # has some of both too: a node whose own Echo comes after it
            # has seen the echo quorum sends its Ready with it, and a Ready
            # quorum can make a node Ready before its echo quorum
            # (contagion), so arm on's must be above arm off's
            share = {a: x["echo_ready_frames"] / max(x["echo_frames"], 1) for a, x in arms.items()}
            if not (on_["echo_ready_frames"] > 0 and share["on"] > share["off"]):
                failures.append(f"node 0's /capturez: {on_['echo_ready_frames']} of {on_['echo_frames']} Echo frames "
                                f"carry their Ready with [wan] on, {off['echo_ready_frames']} of "
                                f"{off['echo_frames']} off")
            if not on_["ready_before_echo_quorum"] > off["ready_before_echo_quorum"]:
                failures.append(f"Readies sent before their echo quorum: {on_['ready_before_echo_quorum']} of "
                                f"{on_['overlap_spans']} spans with [wan] on, {off['ready_before_echo_quorum']} of "
                                f"{off['overlap_spans']} off")
            log(f"wan node net (15a): overlap_ready: {100 * share['on']:.1f}% of node 0's captured Echo frames "
                f"carry their Ready with [wan] on, {100 * share['off']:.1f}% off; Readies sent before their echo "
                f"quorum {on_['ready_before_echo_quorum']} of {on_['overlap_spans']} (transfer, node) spans on, "
                f"{off['ready_before_echo_quorum']} of {off['overlap_spans']} off")
            check(not failures, "phase 15a: " + "; ".join(failures))
            on_run = runs[True]
            paced = [[(1, *plan["seeds"][c])] + [a[:3] for a in on_run["acks"][c]] for c in range(len(plan["paced"]))]
            rejoin = await rejoin_run(nets[True], plan, on_run["burst_transfers"], paced, broker_per, kind,
                                      card_line, tail_per)
        finally:
            for on in (False, True):
                if on not in rcs:
                    stop(on)
    for on in (False, True):
        check(rcs[on] == [0] * NET_NODES, f"phase 15 (arm {'on' if on else 'off'}): servers exited with "
              f"{rcs[on]} on SIGTERM")
        check(brcs.get(on) == 0, f"phase 15 (arm {'on' if on else 'off'}): the broker exited with "
              f"{brcs.get(on)} on SIGINT")
    return {"wan_off": arms["off"], "wan_on": arms["on"], "rejoin": rejoin}


async def membership_path(seed: int, card_line: str, kind: str = "cuda", n_clients: int = MEMBERSHIP_CLIENTS,
                          per: int = MEMBERSHIP_PER) -> dict:
    """15c: four in-process port nodes (``Service.start``) sharing one
    verifier, each with ``[membership] admin_public`` and a 1 s grace, at
    thresholds of every peer. A round of transfers commits on all four;
    an admin-signed ``ConfigTx`` for epoch 1 (remove node 3, thresholds of
    two peers) goes in at node 0 through ``_on_config_tx(None, tx)``; a
    second round goes to nodes 0-2; once the grace is over, the same
    ConfigTx again and one for epoch 5 go in at node 0; a third round
    goes to nodes 0-2."""
    from at2_node_tpu_torch.broadcast.messages import ConfigTx
    from at2_node_tpu_torch.client import Client
    from at2_node_tpu_torch.crypto.keys import SignKeyPair
    from at2_node_tpu_torch.crypto.verifier import make_verifier
    from at2_node_tpu_torch.node.config import MembershipConfig, VerifierConfig
    from at2_node_tpu_torch.node.service import Service
    from at2_node_tpu_torch.ops import cuda_verify
    from at2_node_tpu_torch.tools._common import make_net_configs

    label = "membership node net (15c)"
    rng = np.random.default_rng(seed + 1503)
    admin = SignKeyPair(rng.bytes(32))
    cfgs = make_net_configs(NET_NODES, iter(free_ports(2 * NET_NODES)), seed=seed + 1504,
                            verifier=VerifierConfig(kind=kind),
                            membership=MembershipConfig(admin_public=admin.public.hex(), grace=MEMBERSHIP_GRACE_S))
    verifier = (make_verifier("cuda", batch_size=256, max_delay=0.002) if kind == "cuda"
                else make_verifier(kind))
    await verifier.warmup()
    services: list = []
    clients = [SignKeyPair(rng.bytes(32)) for _ in range(n_clients)]
    rounds = [more_transfers(rng, clients, 1 + k * per, per) for k in range(3)]
    launches0 = cuda_verify.launches

    async def commit_round(k: int, nodes: list) -> None:
        """Round k, client c through node ``nodes[c mod len(nodes)]``; every
        one of ``nodes`` commits it."""
        want = {i: services[i].committed + n_clients * per for i in nodes}

        async def one(c: int) -> None:
            async with Client(f"http://{cfgs[nodes[c % len(nodes)]].rpc_address}") as conn:
                await conn.send_asset_many(clients[c], rounds[k][c])

        await asyncio.gather(*(one(c) for c in range(n_clients)))
        t_end = time.perf_counter() + NET_DEADLINE_S
        while any(services[i].committed < w for i, w in want.items()):
            check(time.perf_counter() < t_end, f"{label}: round {k + 1} committed "
                  f"{[services[i].committed for i in nodes]} on nodes {nodes}, want {list(want.values())}")
            await asyncio.sleep(0.02)

    async def until(cond, what: str, within: float) -> float:
        t0 = time.perf_counter()
        while not cond():
            check(time.perf_counter() - t0 < within, f"{label}: {what} not within {within} s")
            await asyncio.sleep(0.02)
        return time.perf_counter() - t0

    try:
        for cfg in cfgs:
            services.append(await Service.start(cfg, verifier=verifier))
        await until(lambda: all(s.mesh.stats()["channels"] >= 2 * (NET_NODES - 1) for s in services),
                    "the mesh connected", 60.0)
        thresholds0 = [(s.broadcast.echo_threshold, s.broadcast.ready_threshold) for s in services]
        await commit_round(0, list(range(NET_NODES)))
        evicted = cfgs[3].sign_key.public.hex()
        tx = ConfigTx.create(admin, 1, {"remove": [evicted], "echo_threshold": 2, "ready_threshold": 2,
                                        "grace": MEMBERSHIP_GRACE_S})
        t_tx = time.perf_counter()
        services[0]._on_config_tx(None, tx)
        applied_s = await until(lambda: all(s.membership.epoch == 1 for s in services),
                                "every node at epoch 1", 10.0)
        thresholds = [(s.broadcast.echo_threshold, s.broadcast.ready_threshold) for s in services]
        check(thresholds == [(2, 2)] * NET_NODES, f"{label}: thresholds {thresholds} after epoch 1, not (2, 2)")
        await commit_round(1, [0, 1, 2])
        await until(lambda: all(services[i].membership.stats()["evicted_final"] == 1 for i in range(3)),
                    "evicted_final 1 on nodes 0-2", MEMBERSHIP_GRACE_S + 10.0)
        final_s = time.perf_counter() - t_tx
        stats0 = services[0].membership.stats()
        services[0]._on_config_tx(None, tx)  # the same epoch again: gossip echo, not counted
        after_dup = services[0].membership.stats()
        stale = ConfigTx.create(admin, 5, {"echo_threshold": 1, "ready_threshold": 1})
        services[0]._on_config_tx(None, stale)
        after_stale = services[0].membership.stats()
        check(after_dup == stats0, f"{label}: epoch 1 again changed node 0's membership: {stats0} -> {after_dup}")
        check(after_stale == {**stats0, "rejected": stats0["rejected"] + 1},
              f"{label}: the epoch-5 ConfigTx was not counted rejected alone: {stats0} -> {after_stale}")
        check((services[0].broadcast.echo_threshold, services[0].broadcast.ready_threshold) == (2, 2),
              f"{label}: a stale ConfigTx moved node 0's thresholds")
        await commit_round(2, [0, 1, 2])
        ledgers = [await s.accounts.export_state() for s in services]
        replay = replay_ledger([(kp.public, *t) for c, kp in enumerate(clients) for k in range(3)
                                for t in rounds[k][c]])
        for i in range(3):
            check(ledgers[i] == replay, f"{label}: node {i}'s ledger differs from the replay")
        launches = cuda_verify.launches - launches0
        check(kind != "cuda" or launches > 0, f"{label}: the verify kernel never launched")
        stats = [s.membership.stats() for s in services]
        log(f"{label}: {NET_NODES} in-process nodes sharing one {type(verifier).__name__}, [membership] grace "
            f"{MEMBERSHIP_GRACE_S} s, thresholds {thresholds0[0]} (every peer); round 1 ({n_clients} x {per}) "
            f"committed on all {NET_NODES}; the admin's ConfigTx for epoch 1 (remove node 3, echo and ready "
            f"thresholds 2) in at node 0: every node at epoch 1 {applied_s:.3f} s after it, thresholds "
            f"{thresholds[0]} on every node; round 2 committed on nodes 0-2; evicted_final 1 on nodes 0-2 "
            f"{final_s:.3f} s after the ConfigTx; epoch 1 again: node 0's membership unchanged (a duplicate "
            f"is gossip echo, not rejected), epoch 5: rejected {after_stale['rejected']}, nothing else moved; "
            f"round 3 committed on nodes 0-2, their ledgers equal to the replay (node 3 stopped at "
            f"{services[3].committed} commits); membership stats {stats}; verify kernel launches {launches}; "
            f"{card_line}")
        return {"applied_s": applied_s, "evicted_final_s": final_s, "thresholds": thresholds[0],
                "membership": stats, "launches": launches, "seconds": time.perf_counter() - t_tx}
    finally:
        for s in services:
            await s.close()
        await verifier.close()


async def wan_path(seed: int, card_line: str, kind: str = "cuda", paced_s: float = WAN_PACED_S,
                   broker_per: int = WAN_BROKER_PER, burst_per: int = WAN_BURST_PER,
                   tail_per: int = WAN_TAIL_PER, m_clients: int = MEMBERSHIP_CLIENTS,
                   m_per: int = MEMBERSHIP_PER) -> dict:
    """Phase 15: the served ``[wan]`` levers off and on (15a), a node's
    rejoin from its own ``[checkpoint]`` with ``verify_ahead`` (15b), a
    ``[membership]`` epoch change (15c)."""
    t15 = time.perf_counter()
    out = await wan_served_path(seed, card_line, kind, paced_s, broker_per, burst_per, tail_per)
    out["membership"] = await membership_path(seed, card_line, kind, m_clients, m_per)
    off, on = out["wan_off"], out["wan_on"]
    out["seconds"] = time.perf_counter() - t15
    out["launches"] = off["launches"] + on["launches"] + out["rejoin"]["launches"] + out["membership"]["launches"]
    log(f"wan node net (15): paced ack-to-commit p50/p99 {off['paced_p50_ms']:.1f} / {off['paced_p99_ms']:.1f} ms "
        f"[wan] off, {on['paced_p50_ms']:.1f} / {on['paced_p99_ms']:.1f} ms on; broker tier "
        f"{off['broker_p50_ms']:.1f} / {off['broker_p99_ms']:.1f} ms off, {on['broker_p50_ms']:.1f} / "
        f"{on['broker_p99_ms']:.1f} ms on (--eager); burst {off['burst_tx_per_s']:,.0f} / "
        f"{on['burst_tx_per_s']:,.0f} tx/s; node {REJOIN_NODE} live {out['rejoin']['live_s']:.3f} s after its "
        f"restart; phase 15 took {out['seconds']:.1f} s (printed, not gated on); {card_line}")
    return out


# -- phase 16 ---------------------------------------------------------------


DEPLOY_COMPOSE = "deploy/docker-compose.torch.yml"  # the port's activation unit
DEPLOY_MOUNT = "/etc/at2/node.toml"  # where the unit mounts a node's config
DEPLOY_CHECKPOINT_S = 30.0  # every node's [checkpoint] interval, the runbook's
DEPLOY_QUIET_S = 10.0  # the down starts with no periodic checkpoint due within this
DEPLOY_GRACE_S = 30.0  # the unit's stop_grace_period
DEPLOY_CLI_SENDS = 2  # `client send-asset` calls a CLI wallet (two wallets)
DEPLOY_CLIENTS = 16  # the seeded in-process batch: 16 clients x 64 (SendAssetBatch)
DEPLOY_PER_CLIENT = 64
DEPLOY_LIVE_S = 120.0  # every node `live` within this after the up


def compose_entrypoint() -> list:
    """The port's compose unit's entrypoint as its file states it:
    ``["/bin/sh", "-c", "<command reading DEPLOY_MOUNT>"]``."""
    with open(os.path.join(repo_root(), DEPLOY_COMPOSE)) as f:
        lines = [ln.strip() for ln in f if ln.strip().startswith("entrypoint:")]
    check(len(lines) == 1, f"{DEPLOY_COMPOSE} has {len(lines)} entrypoint lines")
    argv = json.loads(lines[0].split(":", 1)[1])
    check(argv[:2] == ["/bin/sh", "-c"] and DEPLOY_MOUNT in argv[2],
          f"{DEPLOY_COMPOSE}'s entrypoint {argv} is not a shell command reading {DEPLOY_MOUNT}")
    return argv


class DeployNet(ServerNet):
    """Phase 16's four nodes, each an operator's deploy unit run as its
    image would run it, without docker: configured through ``bin/torch/
    server config new`` and ``config get-node`` (the runbook's fragments,
    then a ``[checkpoint]`` under the node's data directory, the unit's
    ``/data``), and started by the compose file's own entrypoint command
    with the node's TOML in place of the mount. ``python`` on PATH is this
    interpreter, as the image's venv is."""

    def __init__(self, kind: str, workdir: str) -> None:
        os.makedirs(workdir, exist_ok=True)
        self.data = [os.path.join(workdir, f"data{i}") for i in range(NET_NODES)]
        self.checkpoints = [os.path.join(d, "ledger.ckpt") for d in self.data]
        for d in self.data:
            os.makedirs(d)
        super().__init__(kind, workdir, tables=lambda i: (
            f'[checkpoint]\npath = "{self.checkpoints[i]}"\ninterval = {DEPLOY_CHECKPOINT_S}\n'))
        self.entrypoint = compose_entrypoint()
        self.spawned = [0.0] * NET_NODES  # each node's last start, wall clock
        self.bin = os.path.join(workdir, "bin")
        os.makedirs(self.bin)
        python = os.path.join(self.bin, "python")
        with open(python, "w") as f:  # not a symlink: a venv's interpreter finds its venv by its own path
            f.write(f'#!/bin/sh\nexec "{sys.executable}" "$@"\n')
        os.chmod(python, 0o755)

    def cli(self, *args: str) -> list:
        return [os.path.join(repo_root(), "bin", "torch", "server"), *args]

    def client(self, *args: str) -> list:
        return [os.path.join(repo_root(), "bin", "torch", "client"), *args]

    def env(self) -> dict:
        env = checkout_env()
        env["PATH"] = self.bin + os.pathsep + env.get("PATH", "")
        return env

    def _spawn(self, i: int, log_mode: str):
        import shlex

        command = self.entrypoint[2].replace(DEPLOY_MOUNT, shlex.quote(self.tomls[i]))
        self.spawned[i] = time.time()
        with open(self.logs[i], log_mode) as out:
            return subprocess.Popen([*self.entrypoint[:2], command], stdin=subprocess.DEVNULL, stdout=out,
                                    stderr=subprocess.STDOUT, env=self.env(), cwd=repo_root())

    def last_checkpoint(self, i: int) -> float:
        """The wall time of node i's last checkpoint write (the file's
        mtime), or of its start while it has written none since: its next
        periodic write comes no earlier than this plus the interval."""
        try:
            return max(os.path.getmtime(self.checkpoints[i]), self.spawned[i])
        except FileNotFoundError:
            return self.spawned[i]

    def run_cli(self, argv: list, text: str = "") -> str:
        """One CLI command run to its end with ``text`` on its input; its
        standard output."""
        proc = subprocess.run(argv, input=text, capture_output=True, text=True, env=self.env(), timeout=120)
        check(proc.returncode == 0, f"{os.path.basename(argv[0])} {' '.join(argv[1:])} exited "
              f"{proc.returncode}: {proc.stderr.strip()[-2000:]}")
        return proc.stdout


def deploy_launches(net: ServerNet, before: list, label: str, card, kind: str) -> list:
    """Each node's verify kernel launches since ``before`` (its /statusz),
    with the card in its build block; each must be above 0 on the card."""
    out = []
    for i in range(net.n):
        build = net.statusz(i)["build"]
        out.append(build["kernel_launches"] - before[i]["build"]["kernel_launches"])
        if kind == "cuda":
            check(build.get("device") == card, f"{label} node {i}'s build block names {build.get('device')!r}")
            check(out[-1] > 0, f"{label} node {i}: the verify kernel did not launch")
    return out


async def deploy_run(net: DeployNet, rng, label: str, card, kind: str, n_clients: int, per_client: int,
                     cli_sends: int) -> dict:
    """Phase 16 on a started ``DeployNet``: traffic, the ledgers, the down,
    the checkpoints, the up, the balances through the CLI, one more
    transfer."""
    try:
        import tomllib
    except ModuleNotFoundError:  # Python < 3.11
        import tomli as tomllib

    from at2_node_tpu_torch.crypto.keys import SignKeyPair

    n = net.n
    # the runbook's wallets: `client config new` against node w's RPC port
    wallets = await asyncio.gather(*(asyncio.to_thread(
        net.run_cli, net.client("config", "new", f"http://127.0.0.1:{net.rpc_ports[w]}")) for w in range(2)))
    pubs = await asyncio.gather(*(asyncio.to_thread(net.run_cli, net.client("config", "get-public-key"), w)
                                  for w in wallets))
    wallet_keys = [SignKeyPair.from_hex(tomllib.loads(w)["private_key"]) for w in wallets]
    check([p.strip() for p in pubs] == [k.public.hex() for k in wallet_keys],
          f"{label}: `client config get-public-key` disagrees with the wallets' keys")
    by_cli = [[(seq, wallet_keys[1 - w].public, int(rng.integers(1, 51))) for seq in range(1, cli_sends + 1)]
              for w in range(2)]
    clients = [SignKeyPair(rng.bytes(32)) for _ in range(n_clients)]
    batch = more_transfers(rng, clients, 1, per_client)
    everyone, history = clients + wallet_keys, batch + by_cli
    total = sum(map(len, history))

    def send_cli(w: int, transfers: list) -> None:
        for seq, recipient, amount in transfers:
            net.run_cli(net.client("send-asset", str(seq), recipient.hex(), str(amount)), wallets[w])

    before = [net.statusz(i) for i in range(n)]
    t0 = time.perf_counter()
    await asyncio.gather(*(asyncio.to_thread(send_cli, w, by_cli[w]) for w in range(2)),
                         send_batched(net, clients, batch, lambda c: c % n))
    commit_s = wait_committed(net, [total] * n, NET_DEADLINE_S) - t0
    await check_replay(net, everyone, history)
    replay = replay_ledger([(kp.public, *t) for kp, ts in zip(everyone, history) for t in ts])
    traffic_launches = deploy_launches(net, before, label, card, kind)
    log(f"{label}: {total} transfers ({len(clients)} clients x {per_client} SendAssetBatch, 2 CLI wallets x "
        f"{cli_sends} `bin/torch/client send-asset`) committed on all {n} nodes in {commit_s:.3f} s; "
        f"{len(replay)} accounts equal the python-int replay on every node; verify kernel launches a node "
        f"{traffic_launches}")

    # down: SIGTERM to every unit at once, as `docker compose down` on each
    # host, at an instant with no node's periodic checkpoint due within
    # DEPLOY_QUIET_S, so that a write seen after it is the final one
    import signal

    t_quiet = time.perf_counter()
    while True:
        due = [net.last_checkpoint(i) + DEPLOY_CHECKPOINT_S for i in range(n)]
        if min(due) - time.time() > DEPLOY_QUIET_S:
            break
        check(time.perf_counter() - t_quiet < DEPLOY_CHECKPOINT_S + DEPLOY_GRACE_S,
              f"{label}: a periodic checkpoint due at {min(due):.3f} was never written")
        await asyncio.sleep(0.05)
    quiet_s = time.perf_counter() - t_quiet
    t_down_wall, t_down = time.time(), time.perf_counter()
    for p in net.procs:
        p.send_signal(signal.SIGTERM)
        net.terminated.add(p)
    down_s, down_wall = [None] * n, [None] * n
    while any(s is None for s in down_s) and time.perf_counter() - t_down < DEPLOY_GRACE_S:
        for i, p in enumerate(net.procs):
            if down_s[i] is None and p.poll() is not None:
                down_s[i], down_wall[i] = time.perf_counter() - t_down, time.time()
        time.sleep(0.02)
    check(all(s is not None for s in down_s),
          f"{label}: nodes {[i for i, s in enumerate(down_s) if s is None]} still ran {DEPLOY_GRACE_S:.0f} s "
          f"after SIGTERM (the unit's stop_grace_period): docker would kill them")
    rcs = [p.returncode for p in net.procs]
    check(rcs == [0] * n, f"{label}: the nodes exited with {rcs} on SIGTERM")
    for i, path in enumerate(net.checkpoints):
        check(os.path.exists(path) and os.path.getmtime(path) >= t_down_wall,
              f"{label} node {i}: no checkpoint written at its stop ({path})")
        check(down_wall[i] < due[i], f"{label} node {i} exited {down_wall[i] - due[i]:.3f} s after its next "
              f"periodic checkpoint was due: its last write cannot be told from a periodic one")
        snap = rejoin_frontier(path)
        check(snap == replay, f"{label} node {i}: its checkpoint holds {len(snap)} accounts that differ from the "
              f"replay's {len(replay)}")
    log(f"{label}: down (after {quiet_s:.3f} s waiting for a window with no periodic checkpoint due "
        f"within {DEPLOY_QUIET_S:.0f} s, interval {DEPLOY_CHECKPOINT_S:.0f} s): every node exited 0 on SIGTERM "
        f"in {[round(s, 3) for s in down_s]} s (the unit allows {DEPLOY_GRACE_S:.0f} s), each checkpoint "
        f"written at its stop and equal to the replay")

    # up again from the same configs and data directories
    t_up = time.perf_counter()
    for i in range(n):
        net.restart(i)
    rpc_s, live_s, states = [None] * n, [None] * n, [[] for _ in range(n)]
    while any(s is None for s in live_s):
        check(time.perf_counter() - t_up < DEPLOY_LIVE_S,
              f"{label}: nodes {[i for i, s in enumerate(live_s) if s is None]} not live {DEPLOY_LIVE_S:.0f} s "
              f"after the up (states {states})")
        for i in range(n):
            if live_s[i] is not None:
                continue
            check(net.procs[i].poll() is None,
                  f"{label} node {i} exited with {net.procs[i].returncode}: {net.log_tail(i)}")
            if rpc_s[i] is None:
                if not net._accepts(net.rpc_ports[i]):
                    continue
                rpc_s[i] = time.perf_counter() - t_up
            state = net.statusz(i)["recovery"]["state"]
            if not states[i] or states[i][-1] != state:
                states[i].append(state)
            if state == "live":
                live_s[i] = time.perf_counter() - t_up
        await asyncio.sleep(0.05)
    check(all("cold" not in s for s in states), f"{label}: a node restored from its checkpoint reported {states}")
    got = await asyncio.gather(*(asyncio.to_thread(net.run_cli, net.client("get-balance"), w) for w in wallets))
    want = [replay[k.public.hex()][1] for k in wallet_keys]
    check([int(g) for g in got] == want,
          f"{label}: `client get-balance` read {[g.strip() for g in got]} after the up, the replay says {want}")
    await check_replay(net, everyone, history)
    log(f"{label}: up: RPC ports {[round(s, 3) for s in rpc_s]} s after the start, live "
        f"{[round(s, 3) for s in live_s]} s (recovery states {[' -> '.join(s) for s in states]}); "
        f"`bin/torch/client get-balance` read back {got[0].strip()} and {got[1].strip()}, every node's ledger "
        f"equal to the replay")

    # one more transfer through the CLI commits on all four
    up = [net.statusz(i) for i in range(n)]
    more = (cli_sends + 1, wallet_keys[1].public, int(rng.integers(1, 51)))
    send_cli(0, [more])
    for i in range(n):
        await wait_sequences(net, i, [wallet_keys[0]], cli_sends + 1, NET_DEADLINE_S)
    by_cli[0].append(more)
    await check_replay(net, everyone, history)
    after_launches = deploy_launches(net, up, label, card, kind)
    log(f"{label}: one more `client send-asset` committed on all {n} nodes after the up; verify kernel "
        f"launches a node {after_launches}")
    return {"transfers": total + 1, "commit_s": commit_s,
            "launches": sum(traffic_launches) + sum(after_launches),
            "nodes": [{"launches": a, "launches_after_up": b, "down_s": d, "rpc_up_s": r, "live_s": v,
                       "states": s} for a, b, d, r, v, s in zip(traffic_launches, after_launches, down_s, rpc_s,
                                                                 live_s, states)]}


async def deploy_path(seed: int, card_line: str, kind: str = "cuda", net: DeployNet | None = None,
                      n_clients: int = DEPLOY_CLIENTS, per_client: int = DEPLOY_PER_CLIENT,
                      cli_sends: int = DEPLOY_CLI_SENDS) -> dict:
    """Phase 16: deploy/README_torch.md's runbook on four nodes. ``net``: a
    ``DeployNet`` already started (``start_pair``), else one is started
    here; either way it is stopped here."""
    import contextlib
    import tempfile

    label = "deploy unit (16)"
    card = card_line.split(",")[0] if kind == "cuda" else None
    rng = np.random.default_rng([seed, 16])
    with contextlib.ExitStack() as stack:
        if net is None:
            net = DeployNet(kind, stack.enter_context(tempfile.TemporaryDirectory(prefix="at2-phase16-")))
            start_pair([net], label)
        log(f"{label}: {net.n} nodes configured by bin/torch/server config new + get-node with [checkpoint] "
            f"under each data directory, each started by {DEPLOY_COMPOSE}'s entrypoint "
            f"{' '.join(net.entrypoint[:2])} {json.dumps(net.entrypoint[2])}")
        try:
            out = await deploy_run(net, rng, label, card, kind, n_clients, per_client, cli_sends)
        finally:
            rcs = net.stop()
        check(rcs == [0] * net.n, f"{label}: servers exited with {rcs} on SIGTERM")
        log(f"{label}: every server exited 0 on SIGTERM; {card_line}")
    return out


def device_share(run: dict, by_lanes: dict) -> float:
    """Kernel time on the card over the run's wall time, from phase 3's
    per-bucket kernel times (device clock) and the run's flush buckets."""
    return sum(by_lanes[b]["ms"] for b in run["buckets"]) / (1e3 * run["wall_s"])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=2026)
    args = ap.parse_args()

    sys.path.insert(0, repo_root())
    import torch

    global SENTINEL
    SENTINEL = StallSentinel()
    laps: dict = {}  # seconds a phase, in the order they ran
    stalls: dict = {}  # the sentinel's longest overshoot a phase, ms
    t_lap = [time.perf_counter()]

    def lap(name: str) -> None:
        now = time.perf_counter()
        laps[name] = round(now - t_lap[0], 1)
        t_lap[0] = now
        log(f"phase {name}: {laps[name]} s; {SENTINEL.reading()}; load average {os.getloadavg()}")
        stalls[name] = round(1e3 * SENTINEL.take(), 1)

    card = device_report(torch)
    import tempfile

    # phase 11's runs that need neither the card nor another phase go on
    # SIM_WORKERS cores beside phases 2-3c; phase 3 runs as soon as the
    # verify kernel is built, while the RLC kernels still build
    with ThreadPoolExecutor(max_workers=SIM_WORKERS) as sim_pool:
        sims = sim_start(sim_pool)
        from at2_node_tpu_torch import prebuild

        prebuild.remove_kernel_libs()
        with ThreadPoolExecutor(max_workers=1) as builder:
            built = builder.submit(prebuild.build_libs, log)
            rng = np.random.default_rng(args.seed)
            t0 = time.perf_counter()
            mat = Material(args.seed)
            mat.cross_check()
            log(f"material: {len(mat.valid)} valid items, {len(TAMPER_CLASSES)} tamper classes, "
                f"signed in {time.perf_counter() - t0:.1f} s")
            kp = kernel_vs_plain(torch, mat, rng)  # waits for the verify kernel's build
            lap("1-3")
            ptxas = built.result()
        rlc = rlc_vs_plain(torch, mat, rng)
        times = {"ed25519_verify": kp["by_lanes"], **rlc["by_lanes"]}
        cert = certificate(torch, mat, rng, rlc["by_lanes"])
        lap("3b-3c")
    log(f"phase 11's 11a, 11b and 11d runs ({len(sims)}) ran beside phases 2-3c, {SIM_WORKERS} at a time")
    mp = asyncio.run(main_path(mat, rng))
    lap("4")
    net = asyncio.run(net_path(args.seed, kp["by_lanes"]))
    lap("5")
    device_name = torch.cuda.get_device_name(0)
    # phases 6, 7, 10 and 16 run one after another on nets started side
    # by side (phase 9's process executor counts the card's compute apps,
    # so its nets start after these have stopped)
    simdir = tempfile.TemporaryDirectory(prefix="at2-phase11-")
    capture = os.path.join(simdir.name, "capturez-node0.json")
    with tempfile.TemporaryDirectory(prefix="at2-phase6-") as d6, \
            tempfile.TemporaryDirectory(prefix="at2-phase7-") as d7, \
            tempfile.TemporaryDirectory(prefix="at2-phase10-") as d10, \
            tempfile.TemporaryDirectory(prefix="at2-phase16-") as d16:
        trio = [ServerNet("cuda", d6), ServerNet("cuda", d7, mode="rlc"), finality_net("cuda", d10)]
        unit = DeployNet("cuda", d16)
        try:
            start_pair(trio + [unit], "node nets (6, 7, 10, 16)")
            nodes = asyncio.run(node_path(args.seed, times, device_name, net=trio[0]))
            lap("6")
            rlc_nodes = asyncio.run(node_path(args.seed, times, device_name, mode="rlc",
                                              per_unary=NODE_RLC_PER_UNARY, net=trio[1]))
            log(f"rlc node net (SendAssetBatch): {rlc_nodes['rlc_node_grpc_batched']['tx_per_s']:,.0f} tx/s "
                f"against {nodes['node_grpc_batched']['tx_per_s']:,.0f} tx/s for phase 6's run A (mode "
                f"\"auto\", the verify kernel) in this call")
            lap("7")
            t10 = time.perf_counter()
            finality = asyncio.run(finality_broker_path(args.seed, times, device_name, card, trio[2],
                                                        capture_to=capture))
            log(f"finality and broker node net: [finality] enabled "
                f"{finality['net_finality']['tx_per_s']:,.0f} tx/s (SendAssetBatch), through the broker "
                f"{finality['net_broker']['tx_per_s']:,.0f} tx/s (loadgen --broker, unary SendAsset distilled "
                f"into SendDistilledBatch), against {nodes['node_grpc_batched']['tx_per_s']:,.0f} tx/s for "
                f"phase 6's run A in this call; phase 10 took {time.perf_counter() - t10:.1f} s; {card}")
            lap("10")
            deploy = asyncio.run(deploy_path(args.seed, card, net=unit))
            lap("16")
        finally:
            for srv in trio + [unit]:  # a net already stopped is left as it is
                srv.stop()
    t9 = time.perf_counter()
    planes = asyncio.run(plane_store_path(args.seed, times, device_name, card))
    log(f"plane+store node net (SendAssetBatch): executor \"thread\" "
        f"{planes['plane_store_thread']['tx_per_s']:,.0f} tx/s, \"process\" "
        f"{planes['plane_store_process']['tx_per_s']:,.0f} tx/s, against "
        f"{nodes['node_grpc_batched']['tx_per_s']:,.0f} tx/s for phase 6's run A ([plane] shards = 1, "
        f"no store) in this call; phase 9 took {time.perf_counter() - t9:.1f} s; {card}")
    lap("9")
    pooled = pool_path(torch, mat, rng, args.seed, kp["by_lanes"])
    lap("8")
    sim = sim_path(capture, card, sims)
    simdir.cleanup()
    lap("11")
    tools, tool_launches = tools_path(args.seed, cert, card, k1=kp["by_lanes"][65536])
    lap("12")
    overload = asyncio.run(overload_path(args.seed, times, device_name, card))
    lap("13")
    overload_ab = asyncio.run(overload_ab_path(args.seed, card))
    lap("14")
    wan = asyncio.run(wan_path(args.seed, card))
    lap("15")
    log(f"phase seconds (in the order they ran): {json.dumps(laps)}, {sum(laps.values()):.1f} in all; {card}")
    log(f"stall sentinel (the longest overshoot of a {1e3 * SENTINEL_TICK_S:.0f} ms sleep a phase, ms): "
        f"{json.dumps(stalls)}; {card}")

    from at2_node_tpu_torch.ops import cuda_verify

    runs = {}
    for name, run in mp.items():
        share = device_share(run, kp["by_lanes"])
        log(f"main path ({name}): kernel busy {100 * share:.1f}% of the wall time "
            f"(phase 3 kernel times summed over its {run['launches']} launches)")
        runs[name] = {
            "launches": run["launches"], "sigs_per_s": run["sigs_per_s"],
            "wall_s": run["wall_s"], "kernel_busy_share": share,
            "flush_buckets": {str(b): c for b, c in sorted(Counter(run["buckets"]).items())},
        }
    runs.update(net)
    runs.update(nodes)
    runs.update(planes)
    runs.update(finality)
    top = kp["by_lanes"][65536]
    kernels = [{
        "name": "ed25519_verify",
        "route": "cuda",
        "source": "at2_node_tpu_torch/csrc/ed25519_verify.cu",
        "replaces": "at2_node_tpu/ops/pallas_verify.py:232",
        "launches": (mp["stress"]["launches"] + tool_launches["ed25519_verify"] + overload["launches"]
                     + overload_ab["launches"] + wan["launches"] + deploy["launches"]),
        "mismatches": kp["mismatches"],
        "max_abs_err": kp["max_abs_err"],
        "lanes": 65536,
        "ms": top["ms"],
        "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"],
        "bound_by": top["bound_by"],
        "library_ms": None,
        "threads_per_signature": cuda_verify.THREADS_PER_SIGNATURE,
        **ptxas["ed25519_verify_kernel"],
        "by_lanes": {str(n): r for n, r in kp["by_lanes"].items()},
        "main_path": {**runs, "tools": {row["tool"]: row.get("launches", {}).get("ed25519_verify", 0)
                                        for row in tools},
                      "overload": {arm: [p["launches"] for p in overload[f"overload_{arm}"]["nodes"]]
                                   for arm in ("off", "on")},
                      "overload_ab": {"intake": overload_ab["intake"]["launches"],
                                      **{f"{r['workload']}/{r['arm']}": r["kernel_launches"]
                                         for r in overload_ab["rows"]}},
                      "wan": {"off": [p["launches"] for p in wan["wan_off"]["nodes"]],
                              "on": [p["launches"] for p in wan["wan_on"]["nodes"]],
                              "rejoin": wan["rejoin"]["launches"], "membership": wan["membership"]["launches"]},
                      "deploy": {"traffic": [p["launches"] for p in deploy["nodes"]],
                                 "after_up": [p["launches_after_up"] for p in deploy["nodes"]]}},
        "card": card,
    }]
    # the RLC kernels' main path: phase 7's node net (the processes' counts)
    rlc_launches = sum(r["rlc_launches"] for r in rlc_nodes.values())
    check(rlc_launches > 0, "phase 7 ran without launching the RLC kernels")
    # the lanes kernel's layouts: threads a lane and ptxas figures of each
    # instantiation; the top-level figures are those of the layout the
    # 65,536 bucket takes, the main path's bucket (256) takes its own
    from at2_node_tpu_torch.ops import cuda_rlc

    names = cuda_rlc.LAYOUT_NAMES
    top_layout = rlc["by_lanes"]["ed25519_rlc_lanes"][65536]["layout"]
    main_layout = rlc["by_lanes"]["ed25519_rlc_lanes"][256]["layout"]
    layout_fields = {
        "ed25519_rlc_lanes": {
            "layout": top_layout, "main_path_lanes": 256, "main_path_layout": main_layout,
            "split_wave_lanes": rlc["split_wave_lanes"], "blocks_per_sm": rlc["blocks_per_sm"],
            "threads_per_lane": dict(zip(names, cuda_rlc.THREADS_PER_LANE)),
            **ptxas[f"ed25519_rlc_lanes[{top_layout}]"],
            "ptxas_by_layout": {x: ptxas[f"ed25519_rlc_lanes[{x}]"] for x in names},
        },
        "ed25519_rlc_fold": {"threads_per_point": 4, **ptxas["ed25519_rlc_fold"]},
    }
    for name, replaces in (("ed25519_rlc_lanes", "at2_node_tpu/ops/aggregate.py:287"),
                           ("ed25519_rlc_fold", "at2_node_tpu/ops/aggregate.py:325")):
        top = rlc["by_lanes"][name][65536]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "at2_node_tpu_torch/csrc/ed25519_rlc.cu",
            "replaces": replaces,
            "launches": rlc_launches + tool_launches[name],
            "mismatches": rlc["mismatches"][name],
            "max_abs_err": rlc["max_abs_err"][name],
            "lanes": 65536,
            "ms": top["ms"],
            "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"],
            "library_ms": None,
            **layout_fields[name],
            "by_lanes": {str(n): r for n, r in rlc["by_lanes"][name].items()},
            "main_path": {**rlc_nodes, "certificate": cert, "aggregate_bench": tool_launches[name]},
            "card": card,
        })
    # the pool: the verify kernel once a shard; its main path is phase 8's
    # replay, 32-node net and entry (each count set to 0 just before)
    cmp = pooled["compare"]
    top_lanes = max(POOL_TIMED_LANES)
    top = kp["by_lanes"][top_lanes]
    kernels.append({
        "name": "ed25519_verify_pool",
        "route": "cuda",
        "composition": "the verify kernel once a shard, each shard on its own streams",
        "source": "at2_node_tpu_torch/csrc/ed25519_verify.cu",
        "replaces": "at2_node_tpu/parallel/pool.py:81",
        "launches": sum(pooled[k]["launches"] for k in ("replay", "scale_net", "entry")),
        "mismatches": cmp["mismatches"],
        "max_abs_err": cmp["max_abs_err"],
        "lanes": top_lanes,
        "shards": 1,
        "ms": cmp["by_shards"][top_lanes][1],
        "plain_ms": cmp["plain_ms"][1],
        "bound_ms": top["bound_ms"],
        "bound_by": top["bound_by"],
        "library_ms": None,
        "ms_by_shards": {str(n): {str(k): ms for k, ms in r.items()}
                         for n, r in cmp["by_shards"].items()},
        "plain_ms_by_shards": {str(k): ms for k, ms in cmp["plain_ms"].items()},
        "main_path": {k: pooled[k] for k in ("replay", "scale_net", "entry")},
        "card": card,
    })
    print(json.dumps({"sim": sim}))
    print(json.dumps({"overload": overload}))
    print(json.dumps({"overload_ab": {k: overload_ab[k] for k in ("rows", "bars", "intake", "path")}}))
    print(json.dumps({"wan": wan}))
    print(json.dumps({"deploy": deploy}))
    for row in tools:
        print(json.dumps(row))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    try:
        main()
    except Exception as exc:  # the line that says which check ended the call
        log(f"FAILED: {exc}")
        raise
