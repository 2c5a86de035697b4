"""The key rule of the odometry window solve's CUDA graphs
(``registration/solve_graph``), on the CPU: frames with the same number of
existing window states, shapes and configuration share a key; 2, 3 and 4
existing states give three keys; the IMU switch and the kernel switches
give keys of their own; a CPU tensor never builds a graph (``lm_graph.*``
stay 0).  The graphs themselves are held to the eager path on the card by
``tests/test_torch_kernels_cuda.py``."""

import pytest

from randt_slam_torch.pipeline import slam
from randt_slam_torch.registration import matcher, solve_graph
from tests.test_torch_kernels_cuda import (GRAPH_COUNTERS, GRAPH_MATCHER, graph_config,
                                           graph_counts, graph_frames)
from tests.torch_threads import one_thread  # noqa: F401


@pytest.fixture(scope="module")
def cpu_keys():
    """Per configuration, the (n_exist, key) of every window solve of a
    14-frame CPU run (two submap switches), and the graph counters' change
    and the captures over all three runs."""
    frames = graph_frames(7, 14, "cpu")
    keys, captures = {}, []
    before = graph_counts()
    solve = matcher._window_solve
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(solve_graph.SolveGraphs, "_capture",
                   lambda self, *a: captures.append(a))
        for name in GRAPH_MATCHER:
            seen = keys[name] = []

            def spy(mcfg, n_exist, *args, seen=seen):
                seen.append((n_exist, solve_graph.key((mcfg, n_exist), args)))
                return solve(mcfg, n_exist, *args)

            mp.setattr(matcher, "_window_solve", spy)
            slam.run_odometry(graph_config(name), frames, device="cpu")
    after = graph_counts()
    return keys, {k: after[k] - before[k] for k in GRAPH_COUNTERS}, captures


@pytest.mark.parametrize("case", ["shared", "n_exist", "use_imu", "switches", "cpu"])
def test_window_graph_key_rule(cpu_keys, case):
    keys, counted, captures = cpu_keys
    off = keys["off"]
    by_n = {}
    for n, k in off:
        by_n.setdefault(n, set()).add(k)
    if case == "shared":
        # every n_exist occurs more than once, always under one key
        assert all(sum(n == m for m, _ in off) > 1 for n in by_n)
        assert all(len(ks) == 1 for ks in by_n.values())
    elif case == "n_exist":
        assert sorted(by_n) == [2, 3, 4]
        assert len({next(iter(ks)) for ks in by_n.values()}) == 3
    elif case in ("use_imu", "switches"):
        # the IMU on against the switches on alone; those against both off
        other, base = (keys["imu"], keys["on"]) if case == "use_imu" else (keys["on"], off)
        assert sorted({n for n, _ in other}) == [2, 3, 4]
        assert len({k for _, k in other}) == 3
        assert not {k for _, k in other} & {k for _, k in base}
    else:
        # a CPU tensor runs the solve eagerly and builds no graph
        assert counted == {k: 0 for k in GRAPH_COUNTERS}
        assert not captures
