"""Multi-device runs of the port (``parallel/mesh.py`` and the sharded paths)
against the JAX package's mesh paths, on CPU processes joined by gloo.

As ``tests/test_distributed.py`` does for the JAX package, worlds of real
OS processes (2 and 4 ranks, one CPU each) are joined over 127.0.0.1 by
``init_distributed`` from the ``RANDT_*`` variables.  The children import
torch and the port only and write what they computed to the test's
temporary directory; this process computes the JAX package's results on
its 8-device CPU mesh while they run, and compares.

What must hold, and why:

* ``init_distributed``: a no-op returning False for one process; True in a
  world, with gloo on ``device="cpu"``; ``data_group(2)`` in a world of 4
  reduces over ranks 0 and 1 only.
* ``all_reduce_sum`` and ``all_gather_cat``: the exact sum, and the ranks'
  tensors in rank order (``all_gather(tiled=True)``).
* ``optimize_distributed`` with 2 and 4 ranks on ``make_circle_graph(n=24,
  drift=0.03, n_loops=3)``: the iteration count of the JAX
  ``optimize_distributed`` on ``data_mesh(8)``, the poses within 1e-4 m /
  1e-5 rad of it (``test_torch_pose_graph.py``'s tolerance: float32 LM in
  both, float order apart) and within 5e-3 of ``pose_graph.optimize``
  (``tests/test_multichip.py``'s band); every rank the same poses.
* the sharded ``optimize_schur`` over 2 ranks on ``test_torch_schur.py``'s
  graphs (``many_loops`` has 3 submaps, so one empty submap pads it to 4):
  the iteration count of the port's single-process solve, and its poses
  (bitwise on the CPU: the gathered blocks arrive in submap order, and
  each submap's factorization has the same bits in a slice of the batch);
  within that file's 1e-4 m (plus 1e-5 of the pose's size) of the JAX
  ``optimize_schur(mesh=data_mesh(8))``.
* the sharded batch (``make_batched_scan`` with a group): 4 members over 2
  ranks, two sequences each taken from frame 0 and from frame 3.  Each
  rank's members bit for bit the port's single-process B = 2 run of them;
  every rank returns all 4; against the JAX
  ``make_batched_scan(mesh=data_mesh(2))``, ``test_torch_batch.py``'s
  tables rule and free-running bands.  A batch that does not split over
  the ranks raises.
* rank-local frames, in both worlds: each rank given only its own
  members' frames (two chunks of 3 of the batch's first 6 frames) returns
  all 4 members in order, bit for bit the port's one-process B = 4 run,
  and within the bands above of the JAX ``make_batched_scan(mesh=
  data_mesh(4))`` on the same 6 frames; frames that are neither its share
  nor the whole batch raise.  With
  counting on, ``gather.bytes`` adds each chunk's gathered bytes once; the
  rings gathered on rank 0 (``profiling.gather_records``) hold every
  rank's spans with its rank (each rank's own spans carry it too), one
  ``randt.gather_outputs`` per rank and chunk after its
  ``randt.batch_chunk`` has ended, and on the shared clock no rank's
  all-gather ends before the last rank has entered it.
* one rank in this process (a gloo group of one): ``optimize_distributed``,
  ``optimize_schur``, ``optimize_auto`` and the batch bitwise equal to
  their unsharded calls.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from randt_slam_tpu.config import GlobalFuserConfig as jGFC
from randt_slam_tpu.config import synthetic_config as j_cfg
from randt_slam_tpu.graph import pose_graph as jPG
from randt_slam_tpu.graph import schur as jschur
from randt_slam_tpu.io import formats, synthetic
from randt_slam_tpu.parallel import batch as jB
from randt_slam_tpu.parallel.mesh import data_mesh
from randt_slam_tpu.pipeline import slam as jS
from randt_slam_torch import state
from randt_slam_torch.config import GlobalFuserConfig as tGFC
from randt_slam_torch.config import synthetic_config as t_cfg
from randt_slam_torch.graph import pose_graph as tPG
from randt_slam_torch.graph import schur as tschur
from randt_slam_torch.parallel import batch as tB
from randt_slam_torch.parallel import mesh
from randt_slam_torch.pipeline import frontend as tF
from randt_slam_torch.pipeline import slam as tS
from tests.test_pose_graph import make_circle_graph
from tests.test_torch_batch import FREE_ANG, FREE_ATE, FREE_POS, TABLES
from tests.test_torch_schur import GRAPHS, POSE_REL, TOL, _se2_close
from tests.test_schur import _slam_graph
from tests.torch_threads import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PGO_POS, PGO_ANG = 1e-4, 1e-5
DENSE_BAND = 5e-3
SCHUR_GRAPHS = list(GRAPHS)
# the sharded batch: (seed, first frame) per member, T frames each
MEMBERS = ((3, 0), (4, 0), (3, 3), (4, 3))
T = 22
LOCAL_FRAMES = 6   # the rank-local frames' run: two chunks of 3
CHILD_TIMEOUT = 300

_CHILD = textwrap.dedent("""
    import json, os, sys
    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from randt_slam_torch.config import GlobalFuserConfig, synthetic_config
    from randt_slam_torch.graph import pose_graph as PG
    from randt_slam_torch.graph import schur
    from randt_slam_torch.parallel import batch, mesh
    from randt_slam_torch.pipeline import frontend as F
    from randt_slam_torch.pipeline import slam
    from randt_slam_torch import state

    spec = json.loads(sys.argv[1])
    joined = mesh.init_distributed(device="cpu")
    rank, world = dist.get_rank(), dist.get_world_size()
    group = mesh.data_group()
    res = {"joined": joined, "rank": rank, "world": world,
           "backend": dist.get_backend(group)}

    x = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10.0 * rank
    res["all_reduce"] = mesh.all_reduce_sum(x, group).numpy()
    res["all_gather"] = mesh.all_gather_cat(x, group).numpy()
    if world > 2:  # a sub-group of the first two ranks; every rank creates it
        pair = mesh.data_group(2)
        if rank < 2:
            res["pair_reduce"] = mesh.all_reduce_sum(x, pair).numpy()

    def graph(prefix, data):
        return state.pose_graph_from_numpy(PG.PoseGraph(
            *(data[f"{prefix}.{k}"] for k in PG.PoseGraph._fields)), "cpu")

    data = np.load(spec["graphs"])
    poses, info = schur.optimize_distributed(graph("pgo", data), GlobalFuserConfig(), group)
    res["pgo.poses"], res["pgo.iterations"] = poses.numpy(), info["iterations"]
    for name in spec["schur"]:
        g = graph(f"schur.{name}", data)
        ns, nr = data[f"schur.{name}.node_submap"], data[f"schur.{name}.node_is_root"]
        poses, info = schur.optimize_schur(g, GlobalFuserConfig(), ns, nr, group=group)
        res[f"schur.{name}.poses"] = poses.numpy()
        res[f"schur.{name}.iterations"] = info["iterations"]

    def flat(outs, prefix):
        for k, v in outs._asdict().items():
            if isinstance(v, tuple):
                for kk, vv in v._asdict().items():
                    res[f"{prefix}.{k}.{kk}"] = vv
            elif v is not None:
                res[f"{prefix}.{k}"] = v

    if spec.get("batch"):
        b = np.load(spec["batch"])
        intensity, stamps = b["intensity"], b["stamps"]
        B = len(intensity)
        members = [slam.frames_from_arrays(intensity[i], b["azimuths"], b["ranges"],
                                           stamps[i], device="cpu") for i in range(B)]
        frames = F.Frame(*(torch.stack(x) for x in zip(*members)))
        cfg = synthetic_config()
        carries = batch.init_batched_carry(cfg, B, device="cpu", group=group)
        res["local_members"] = carries.cur_pose.shape[0]
        _, outs = batch.make_batched_scan(cfg, np.zeros(3), device="cpu", group=group)(
            carries, frames)
        flat(outs, "sharded")
        lo, hi = mesh.shard_range(B, group)
        own = F.Frame(*(x[lo:hi] for x in frames))
        _, outs = batch.make_batched_scan(cfg, np.zeros(3), device="cpu")(
            batch.init_batched_carry(cfg, hi - lo, device="cpu"), own)
        flat(outs, "single")
        try:
            batch.make_batched_scan(cfg, np.zeros(3), device="cpu", group=group)(
                carries, F.Frame(*(x[:B - 1] for x in frames)))
            res["odd_batch_raises"] = False
        except ValueError:
            res["odd_batch_raises"] = True
    if spec.get("local"):
        # rank-local frames: each rank is given its own members' frames
        # alone, in two chunks, counting, and the rings go to rank 0
        from randt_slam_torch.utils import profiling
        b = np.load(spec["local"])
        B, n = len(b["intensity"]), spec["local_frames"]
        lo, hi = mesh.shard_range(B, group)
        own = [slam.frames_from_arrays(b["intensity"][i, :n], b["azimuths"], b["ranges"],
                                       b["stamps"][i, :n], device="cpu") for i in range(lo, hi)]
        own = F.Frame(*(torch.stack(x) for x in zip(*own)))
        cfg = synthetic_config()
        scan = batch.make_batched_scan(cfg, np.zeros(3), device="cpu", group=group)
        carries = batch.init_batched_carry(cfg, B, device="cpu", group=group)
        since, bytes0 = profiling.REGISTRY.n, profiling.counter("gather.bytes")
        chunks, half = [], n // 2
        with profiling.tracing():
            for c in range(2):
                carries, outs = scan(carries, F.Frame(*(x[:, c * half:(c + 1) * half]
                                                        for x in own)))
                chunks.append(outs)
        res["gather_bytes"] = profiling.counter("gather.bytes") - bytes0
        res["gather_bytes_want"] = sum(x.nbytes for o in chunks for x in batch._leaves(o))
        def cat(xs):  # the chunks' outputs joined along the frames
            if xs[0] is None:
                return None
            if isinstance(xs[0], tuple):
                return type(xs[0])(*(cat(list(y)) for y in zip(*xs)))
            return np.concatenate(xs, axis=1)
        flat(cat(chunks), "local")
        res["spans_carry_rank"] = all(r.ids.get("rank") == rank
                                      for r in profiling.records(since))
        try:  # neither the rank's share nor the whole batch
            scan(carries, F.Frame(*(torch.cat([x, x[:1]]) for x in own)))
            res["local_odd_raises"] = False
        except ValueError:
            res["local_odd_raises"] = True
        recs = profiling.gather_records(group, since=since)
        if rank == 0:
            res["rec.name"] = np.array([r.name for r in recs])
            for k in ("rank", "chunk"):
                res[f"rec.{k}"] = np.array([r.ids.get(k, -1) for r in recs])
            res["rec.start"] = np.array([r.start for r in recs], np.int64)
            res["rec.end"] = np.array([r.end for r in recs], np.int64)
        else:
            res["rec.none"] = recs is None
    np.savez(os.path.join(spec["out"], f"rank{rank}.npz"), **res)
    dist.destroy_process_group()
""")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn(world, spec, out):
    """Start a world of ``world`` ranks running the child script."""
    os.makedirs(out, exist_ok=True)
    script = os.path.join(out, "child.py")
    with open(script, "w") as f:
        f.write(_CHILD)
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
                   RANDT_COORDINATOR=f"127.0.0.1:{port}",
                   RANDT_NUM_PROCESSES=str(world), RANDT_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, script, json.dumps(dict(spec, out=out))], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def _join(procs, out):
    """Wait for every rank; each must exit 0.  Returns their results."""
    logs = []
    for p in procs:
        try:
            log, _ = p.communicate(timeout=CHILD_TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            log, _ = p.communicate()
        logs.append(log)
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{log[-4000:]}"
    return [dict(np.load(os.path.join(out, f"rank{r}.npz"))) for r in range(len(procs))]


def _save_graph(data, prefix, g):
    for k, v in g._asdict().items():
        data[f"{prefix}.{k}"] = np.asarray(v)


def _pgo_graph():
    g, _, _ = make_circle_graph(np.random.default_rng(0), n=24, drift=0.03, n_loops=3)
    return jPG.PoseGraph(*(np.asarray(x) for x in g))


def _member_arrays(seqs):
    seq = {s: q for s, q in zip((3, 4), seqs)}
    return dict(
        intensity=np.stack([seq[s].intensity[o:o + T] for s, o in MEMBERS]),
        stamps=np.stack([seq[s].stamps[o:o + T] for s, o in MEMBERS]),
        gt=np.stack([seq[s].gt_poses[o:o + T] for s, o in MEMBERS]),
        azimuths=seqs[0].azimuths, ranges=seqs[0].ranges)


def _unflat(res, prefix):
    """A FrameOutput of numpy arrays from a child's flattened leaves."""
    def rec(cls, name):
        return cls(**{k: res[f"{prefix}.{name}.{k}"] for k in cls._fields})
    rest = {k: res.get(f"{prefix}.{k}") for k in tF.FrameOutput._fields
            if k not in ("nodes", "edges")}
    return tF.FrameOutput(nodes=rec(tF.NodeRecord, "nodes"),
                          edges=rec(tF.EdgeRecord, "edges"), **rest)


def _member(outs, b):
    return jax.tree.map(lambda x: np.asarray(x)[b], outs)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds' results and the JAX package's, computed while they ran."""
    d = str(tmp_path_factory.mktemp("dist"))
    graphs = {}
    _save_graph(graphs, "pgo", _pgo_graph())
    for name in SCHUR_GRAPHS:
        g, ns, nr, _ = _slam_graph(**GRAPHS[name])
        _save_graph(graphs, f"schur.{name}", g)
        graphs[f"schur.{name}.node_submap"] = ns
        graphs[f"schur.{name}.node_is_root"] = nr
    np.savez(os.path.join(d, "graphs.npz"), **graphs)
    seqs = [synthetic.generate(seed=s, n_frames=T + 3, n_azimuths=256, n_bins=256,
                               speed=4.0, dt=0.25) for s in (3, 4)]
    arrays = _member_arrays(seqs)
    np.savez(os.path.join(d, "batch.npz"), **arrays)
    spec = dict(graphs=os.path.join(d, "graphs.npz"), schur=SCHUR_GRAPHS,
                local=os.path.join(d, "batch.npz"), local_frames=LOCAL_FRAMES)
    # the four ranks' cases: dense, collectives, rank-local frames
    four = _spawn(4, dict(spec, schur=[]), os.path.join(d, "w4"))
    try:
        two = _spawn(2, dict(spec, batch=os.path.join(d, "batch.npz")),
                     os.path.join(d, "w2"))
    except BaseException:
        for p in four:
            p.kill()
        raise
    try:
        ref = {}
        cfg = jGFC()
        p, info = jschur.optimize_distributed(_pgo_graph(), cfg, data_mesh(8))
        ref["pgo"] = (np.asarray(p), int(info["iterations"]))
        ref["pgo_dense"] = np.asarray(jPG.optimize(_pgo_graph(), cfg)[0])
        for name in SCHUR_GRAPHS:
            g, ns, nr, _ = _slam_graph(**GRAPHS[name])
            p, info = jschur.optimize_schur(g, cfg, ns, nr, mesh=data_mesh(8))
            ref[f"schur.{name}"] = (np.asarray(p), int(info["iterations"]))
        fr = [jS.frames_from_arrays(arrays["intensity"][b], arrays["azimuths"],
                                    arrays["ranges"], arrays["stamps"][b])
              for b in range(len(MEMBERS))]
        frames = jax.tree.map(lambda *x: jnp.stack(x), *fr)
        jcfg = j_cfg()
        _, outs = jB.make_batched_scan(jcfg, jnp.zeros(3), mesh=data_mesh(2))(
            jB.init_batched_carry(jcfg, len(MEMBERS)), frames)
        ref["batch"] = jax.tree.map(np.asarray, outs)
        _, outs = jB.make_batched_scan(jcfg, jnp.zeros(3), mesh=data_mesh(4))(
            jB.init_batched_carry(jcfg, len(MEMBERS)),
            jax.tree.map(lambda x: x[:, :LOCAL_FRAMES], frames))
        ref["local_jax"] = jax.tree.map(np.asarray, outs)
        local = tF.Frame(*(torch.stack(x) for x in zip(*(
            tS.frames_from_arrays(arrays["intensity"][b, :LOCAL_FRAMES], arrays["azimuths"],
                                  arrays["ranges"], arrays["stamps"][b, :LOCAL_FRAMES],
                                  device="cpu") for b in range(len(MEMBERS))))))
        tcfg = t_cfg()
        ref["local"] = tB.make_batched_scan(tcfg, np.zeros(3), device="cpu")(
            tB.init_batched_carry(tcfg, len(MEMBERS), device="cpu"), local)[1]
    finally:
        res = {4: _join(four, os.path.join(d, "w4")), 2: _join(two, os.path.join(d, "w2"))}
    return res, ref, arrays


def test_init_distributed_is_a_noop_for_one_process(monkeypatch):
    for k in ("RANDT_COORDINATOR", "RANDT_NUM_PROCESSES", "RANDT_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert mesh.init_distributed(device="cpu") is False
    monkeypatch.setenv("RANDT_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("RANDT_NUM_PROCESSES", "1")
    assert mesh.init_distributed(device="cpu") is False
    assert not dist.is_initialized()
    assert mesh.data_group() is None and mesh.shard_range(5, None) == (0, 5)
    with pytest.raises(ValueError):
        mesh.data_group(2)
    if not torch.cuda.is_available():  # a world on CUDA with no card: no fallback
        monkeypatch.setenv("RANDT_NUM_PROCESSES", "2")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            mesh.init_distributed()
        assert not dist.is_initialized()


@pytest.mark.parametrize("world", [2, 4])
def test_init_distributed_wiring(worlds, world):
    res = worlds[0][world]
    for rank, r in enumerate(res):
        assert bool(r["joined"]) and int(r["rank"]) == rank and int(r["world"]) == world
        assert str(r["backend"]) == "gloo"


@pytest.mark.parametrize("world", [2, 4])
def test_collectives(worlds, world):
    res = worlds[0][world]
    x = [np.arange(6, dtype=np.float32).reshape(2, 3) + 10.0 * r for r in range(world)]
    for r in res:
        np.testing.assert_array_equal(r["all_reduce"], sum(x))
        np.testing.assert_array_equal(r["all_gather"], np.concatenate(x))
    if world == 4:  # data_group(2): ranks 0 and 1 only
        for r in res[:2]:
            np.testing.assert_array_equal(r["pair_reduce"], x[0] + x[1])
        assert all("pair_reduce" not in r for r in res[2:])


@pytest.mark.parametrize("world", [2, 4])
def test_optimize_distributed_matches_jax(worlds, world):
    res, ref, _ = worlds
    jp, jits = ref["pgo"]
    for r in res[world]:
        assert int(r["pgo.iterations"]) == jits
        np.testing.assert_array_equal(r["pgo.poses"], res[world][0]["pgo.poses"])
    d = np.abs(res[world][0]["pgo.poses"] - jp)
    assert d[:, :2].max() <= PGO_POS and d[:, 2].max() <= PGO_ANG, d.max(axis=0)
    np.testing.assert_allclose(res[world][0]["pgo.poses"], ref["pgo_dense"], atol=DENSE_BAND)


@pytest.mark.parametrize("name", SCHUR_GRAPHS)
def test_sharded_schur_matches_single_and_jax(worlds, name):
    res, ref, _ = worlds
    g, ns, nr, _ = _slam_graph(**GRAPHS[name])
    tg = state.pose_graph_from_numpy(jPG.PoseGraph(*(np.asarray(x) for x in g)), "cpu")
    single, info = tschur.optimize_schur(tg, tGFC(), ns, nr)
    if name == "many_loops":
        assert len(np.unique(ns)) % 2 == 1  # a padded submap on the second rank
    for r in res[2]:
        assert int(r[f"schur.{name}.iterations"]) == info["iterations"]
        np.testing.assert_array_equal(r[f"schur.{name}.poses"], single.numpy())
    _se2_close(res[2][0][f"schur.{name}.poses"], ref[f"schur.{name}"][0], TOL, POSE_REL)


def test_build_layout_padding_equals_jax():
    g, ns, nr, _ = _slam_graph(**GRAPHS["many_loops"])
    for pad in (2, 4, 8):
        want = jschur.build_layout(ns, nr, g.id_begin, g.id_end, pad_submaps_to=pad)
        got = tschur.build_layout(ns, nr, g.id_begin, g.id_end, pad_submaps_to=pad)
        assert got.int_node.shape[0] % pad == 0
        for f in want._fields:
            a, b = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
            assert a.dtype == b.dtype and np.array_equal(a, b), (pad, f)


def test_sharded_batch_members_are_single_runs(worlds):
    res = worlds[0][2]
    for rank, r in enumerate(res):
        assert int(r["local_members"]) == 2 and bool(r["odd_batch_raises"])
        whole, own = _unflat(r, "sharded"), _unflat(r, "single")
        assert whole.odom_pose.shape[0] == len(MEMBERS)
        for k, v in r.items():  # every rank returns the same whole batch
            if k.startswith("sharded."):
                np.testing.assert_array_equal(v, res[0][k], err_msg=k)
        for b in range(2):  # this rank's members: its B = 2 run's bits
            mine, single = _member(whole, 2 * rank + b), _member(own, b)
            for a, c in zip(jax.tree.leaves(mine), jax.tree.leaves(single)):
                np.testing.assert_array_equal(a, c)


def _hold_to_jax(outs, jax_outs, gt):
    """Every member of the port's batch ``outs`` against the JAX package's:
    ``test_torch_batch.py``'s tables rule and free-running bands."""
    for b in range(len(MEMBERS)):
        mine, want = _member(outs, b), _member(jax_outs, b)
        t_tab, j_tab = tS._unstack_outputs(mine), tS._unstack_outputs(want)
        for k in TABLES:
            np.testing.assert_array_equal(t_tab[k], j_tab[k], err_msg=f"{b} {k}")
        np.testing.assert_array_equal(mine.rejected, want.rejected)
        np.testing.assert_array_equal(mine.submap_finished, want.submap_finished)
        gap = abs(formats.ate(mine.odom_pose, gt[b]) - formats.ate(want.odom_pose, gt[b]))
        assert gap < FREE_ATE, (b, gap)
        d = np.abs(mine.odom_pose - want.odom_pose)
        assert d[:, 2].max() <= FREE_ANG and d[:, :2].max() <= FREE_POS, (b, d.max(axis=0))


def test_sharded_batch_matches_jax_batch(worlds):
    res, ref, arrays = worlds
    _hold_to_jax(_unflat(res[2][0], "sharded"), ref["batch"], arrays["gt"])


@pytest.mark.parametrize("world", [2, 4])
def test_rank_local_frames_give_the_one_process_batch(worlds, world):
    """Each rank given only its own members' frames: every rank returns all
    members in order, each bit for bit the one-process batch's and within
    the JAX package's bands of its batch on the same frames; frames that
    are neither the rank's share nor the whole batch raise."""
    res, ref, arrays = worlds
    want = jax.tree.leaves(ref["local"])
    for r in res[world]:
        assert bool(r["local_odd_raises"])
        got = _unflat(r, "local")
        assert got.odom_pose.shape[:2] == (len(MEMBERS), LOCAL_FRAMES)
        for a, b in zip(jax.tree.leaves(got), want, strict=True):
            np.testing.assert_array_equal(a, b)
        _hold_to_jax(got, ref["local_jax"], arrays["gt"][:, :LOCAL_FRAMES])


@pytest.mark.parametrize("world", [2, 4])
def test_rings_reach_rank_0_with_their_rank_on_one_clock(worlds, world):
    res = worlds[0][world]
    assert all(bool(r["rec.none"]) for r in res[1:])   # the records are rank 0's alone
    assert all(bool(r["spans_carry_rank"]) for r in res)  # in a group every span has it
    r0 = res[0]
    name, rank, chunk = r0["rec.name"], r0["rec.rank"], r0["rec.chunk"]
    start, end = r0["rec.start"], r0["rec.end"]
    assert sorted(set(rank.tolist())) == list(range(world))
    assert (name == "randt.frontend_step").sum() == world * LOCAL_FRAMES
    for c in (0, 1):
        gather = (name == "randt.gather_outputs") & (chunk == c)
        assert sorted(rank[gather].tolist()) == list(range(world))
        # no rank's all-gather ends before every rank has entered it: the
        # ranks' clocks line up
        assert start[gather].max() <= end[gather].min()
        for k in range(world):  # the chunk's own work ends before its exchange
            own = (name == "randt.batch_chunk") & (chunk == c) & (rank == k)
            assert own.sum() == 1
            assert end[own][0] <= start[gather & (rank == k)][0]


@pytest.mark.parametrize("world", [2, 4])
def test_gather_bytes_count_each_chunk_once(worlds, world):
    for r in worlds[0][world]:
        assert int(r["gather_bytes"]) == int(r["gather_bytes_want"]) > 0


@pytest.fixture
def one_rank():
    """A gloo group of this process alone."""
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)
    try:
        yield mesh.data_group()
    finally:
        dist.destroy_process_group()


def test_one_rank_in_process_is_bitwise_unsharded(one_rank, worlds):
    group = one_rank
    assert group is dist.group.WORLD
    tg = state.pose_graph_from_numpy(_pgo_graph(), "cpu")
    a, ia = tschur.optimize_distributed(tg, tGFC(), group)
    b, ib = tPG.optimize(tg, tGFC())
    assert ia == ib and torch.equal(a, b)
    g, ns, nr, _ = _slam_graph(**GRAPHS["many_loops"])
    tg = state.pose_graph_from_numpy(jPG.PoseGraph(*(np.asarray(x) for x in g)), "cpu")
    a, ia = tschur.optimize_schur(tg, tGFC(), ns, nr, group=group)
    b, ib = tschur.optimize_schur(tg, tGFC(), ns, nr)
    assert ia == ib and torch.equal(a, b)
    kw = dict(node_submap=ns, node_is_root=nr, dense_node_limit=8)
    a, ia = tschur.optimize_auto(tg, tGFC(), group=group, **kw)
    b, ib = tschur.optimize_auto(tg, tGFC(), **kw)
    assert ia == ib and torch.equal(a, b)
    arrays, n = worlds[2], 6
    members = [tS.frames_from_arrays(arrays["intensity"][i, :n], arrays["azimuths"],
                                     arrays["ranges"], arrays["stamps"][i, :n], device="cpu")
               for i in range(2)]
    frames = tF.Frame(*(torch.stack(x) for x in zip(*members)))
    cfg = t_cfg()
    outs = [tB.make_batched_scan(cfg, np.zeros(3), device="cpu", group=grp)(
        tB.init_batched_carry(cfg, 2, device="cpu", group=grp), frames)[1]
        for grp in (group, None)]
    for x, y in zip(jax.tree.leaves(outs[0]), jax.tree.leaves(outs[1])):
        np.testing.assert_array_equal(x, y)
