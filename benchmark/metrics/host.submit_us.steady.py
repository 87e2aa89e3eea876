"""The control plane's and staging's host cost: the harness's host clock
around each callback's ``queue_event`` calls, ``process_block`` and the
readback's enqueue, summed over the window and divided by its blocks."""

from benchmark.readers import submit_us as read  # noqa: F401
