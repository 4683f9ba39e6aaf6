"""Host synchronisations a unit of work inside the program's own spans
(``ft.*``): the CUDA runtime calls that block the host until the card has
finished (a ``bool()`` or ``.item()`` of a device tensor is a
``cudaMemcpyAsync`` and a ``cudaStreamSynchronize``). The window's closing
``torch.cuda.synchronize`` lies outside every program span. Nothing
without device events or program spans."""

from ..spans import tree

SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
         "cudaMemcpy")


def read(record, **_):
    spans = [(s, e) for s, e, _, parent in tree(record) if parent is None]
    if not record.device or not spans or record.units <= 0:
        return None
    n = 0
    for s, _, name in record.host:
        if name in SYNCS and any(a <= s < b for a, b in spans):
            n += 1
    return n / record.units
