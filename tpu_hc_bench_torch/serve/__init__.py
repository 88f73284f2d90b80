"""Serving lane of the PyTorch/CUDA port: paged-KV prefill/decode
programs (``decode``), the continuous-batching engine (``engine``), the
shared-prefix cache (``prefix_cache``), fault injection and the drain
journal (``faults``), the KV pool's summary fold (``kv``), arrivals, the
latency fold (``slo``) and the CLI (``cli``)."""
