"""Device idle milliseconds a step in the gaps whose host operation is the
streaming loader's gather (``pde.gather``, training/trainer.py: a chunk's
host gather from the store's memmaps, methods.py::gather_stream_chunk): of
the traced chunk's longest idle gaps (``trace.summarize`` keeps ten), those
named by the span open at their middle.  The traced fit is one chunk, so
its one gather is one gap, the longest.  None where no gap falls in a
gather."""

SPAN = "pde.gather"


def read(ctx):
    ms = [1e3 * s for name, s in ctx.summary.gaps if SPAN in name.split(" > ")]
    return sum(ms) / ctx.steps if ms else None
