"""Blocking runtime calls an update pass (cudaStreamSynchronize,
cudaDeviceSynchronize, cudaEventSynchronize, a synchronous cudaMemcpy):
those made inside the span `update_pass` in the span window
(`benchmark/harness/spans.py`), over the passes in it."""

from benchmark.harness.spans import per


def read(rec):
    return per(rec, "update_pass", "syncs")
