"""idle_in_program_ms.biascorr: milliseconds a pair that the card is idle while the host is inside
one of the program's spans (its entry points or a stage), by interval over the trace."""

from gpu_bench.spans import idle_in_program_ms


def read(run):
    return idle_in_program_ms(run)
