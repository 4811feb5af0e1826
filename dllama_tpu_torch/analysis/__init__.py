"""The runtime concurrency sanitizer (:mod:`.sanitize`): the ``guarded_by``
annotation convention and the ``DLLAMA_SANITIZE=1`` lock witness that
catches lock-order inversions and unguarded writes live. A copy of the JAX
package's module; the JAX package's static analyzer has no counterpart
here."""
