"""prefill_graph_share (%), layer programs: the share of the window's
placements (``prefill_steps``) whose fresh prefill replayed a captured
graph (``prefill_graph_replays``) instead of enqueueing the prefill launch
by launch; None where no placement ran in the window, or where the engine
keeps no such counter."""


def read(run):
    if "prefill_graph_replays" not in run.counters["close"]:
        return None
    steps = run.delta("prefill_steps")
    return 100.0 * run.delta("prefill_graph_replays") / steps if steps > 0 else None
