"""One module a kind of traffic, found by the kind's name (gpu_bench/traffic.py)."""
