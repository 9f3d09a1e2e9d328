"""fairify_tpu_torch — the PyTorch/CUDA port of ``fairify_tpu``.

A second package beside the JAX one, laid out on the same module paths so
every module has an obvious counterpart (``fairify_tpu_torch.verify.sweep``
ports ``fairify_tpu.verify.sweep``, and so on).  The port imports ``torch``
and never ``jax``, and nothing of ``fairify_tpu``: the few jax-free helpers
it needs are kept as its own copies.

Plain tensor code is PyTorch; the device kernels of the stage-0 sweep are
hand-written CUDA C++ for Hopper (``csrc/``), each beside a plain PyTorch
version of the same function that the CPU tests run.  Entry points run on
``cuda`` unless the caller passes ``device="cpu"``.

Importing the package is cheap and side-effect free apart from the numeric
policy of :mod:`fairify_tpu_torch.utils.num` (true f32 matmuls), which is
applied the first time a numeric module is imported.
"""

__version__ = "0.1.0"


def __getattr__(name):
    # Lazy re-exports (PEP 562): `import fairify_tpu_torch` must not pull in
    # torch for consumers that only want a config or a copied helper.
    if name == "MLP":
        from fairify_tpu_torch.models.mlp import MLP

        return MLP
    if name == "verify_model":
        from fairify_tpu_torch.verify.sweep import verify_model

        return verify_model
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
