"""graph_ops_per_chunk (ops/chunk, device trace): device ops a chunk whose
launching runtime call is a CUDA graph launch (``cudaGraphLaunch``,
``cuGraphLaunch``): the ops the port replays from its dispatch's CUDA
graphs (``runtime/dispatch_graphs.py``) rather than launching one by one.
A trace without graph launches reads 0."""

GRAPH_LAUNCHES = ("cudaGraphLaunch", "cuGraphLaunch")


def read(ctx):
    view = ctx.trace
    if view is None or not view.chunks:
        return None
    ops = sum(calls.get(c, (None, ""))[1].startswith(GRAPH_LAUNCHES)
              for corrs, calls in zip(view.correlations, view.launches) for c in corrs)
    return ops / view.n_chunks
