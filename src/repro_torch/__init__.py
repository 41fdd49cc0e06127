"""PyTorch and CUDA port of the multiversion GC stack (``repro``).

The package mirrors ``src/repro/`` path for path, so every module names the
JAX module it ports:

* ``core.mvgc`` — version slabs, the ``needed(A, t)`` predicate, the
  announcement board, the retire ring and the five-policy store;
* ``mvkv.paged`` — the multiversion paged KV cache;
* ``serve.engine.PagedKVEngine`` — the pressure-driven serving loop;
* ``kernels`` — hand-written CUDA kernels for Hopper (``csrc/*.cu``) with a
  plain PyTorch version beside each.

State is ``NamedTuple``s of tensors with the JAX package's dtypes (int32
everywhere, bool masks), so integer state can be compared bit for bit.
Entry points take ``device=``; they run on ``cuda`` unless the caller asks
for ``"cpu"``, and raise when no GPU is present instead of falling back.
Nothing here imports ``jax`` or ``repro``.
"""
