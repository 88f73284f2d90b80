"""Serving lane of the PyTorch/CUDA port: paged-KV prefill/decode
programs (``decode``), the continuous-batching engine (``engine``),
arrivals, the latency fold (``slo``) and the CLI (``cli``)."""
