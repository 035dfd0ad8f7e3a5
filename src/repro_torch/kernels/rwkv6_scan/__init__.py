"""K7: the RWKV-6 (Finch) WKV recurrence with data-dependent decay, the
time mix of every RWKV layer (``models/rwkv6.apply_rwkv_tmix`` with
``use_kernel=True``)."""
