"""The median wall of a call in the staged window, which runs without the
profiler, less `short.replay_us`: the host's part of a call (copies in and
out, the launch, the waits), in microseconds."""

import statistics

import plugins


def read(obs):
    replay = plugins.load("metrics", "short.replay_us").read(obs)
    if replay is None or obs.staged is None or not obs.staged.walls:
        return None
    return statistics.median(obs.staged.walls) * 1e6 - replay
