"""exchange_ms.mesh4: device-busy milliseconds a call inside the program's ``parallel.exchange``
spans (each family's halo exchange: own blocks, NaN edges and the neighbours' strips), summed over
the cards: each card's busy time within the span's stream interval, its waits on other cards left
out (``gpu_bench.spans.exchange_busy_ms``)."""

from gpu_bench.spans import exchange_busy_ms


def read(run):
    return exchange_busy_ms(run)
