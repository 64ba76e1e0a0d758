"""Model configuration of the port's decode rungs, shared by
``chip_smoke.py`` and ``bench/generate_profile.py``.

``DECODE``: ``benchmarks/transformer_train_bench.py`` ``bench_decode``
at its defaults (the long-context rung, bf16 there) and
``bench_spec_decode`` (the speculative rung, same model).
"""

DECODE = dict(vocab=32768, d_model=1024, n_heads=8, n_kv_heads=2,
              n_layers=8, d_ff=4096, attn="ulysses", attn_impl="flash")
