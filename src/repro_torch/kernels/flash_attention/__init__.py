"""K6: causal GQA flash attention over whole sequences (the no-cache
forward), and K5: single-query GQA decode attention against a KV cache with
per-slot valid lengths (the serving path's flash-decode)."""
