"""repro_torch: the PyTorch/CUDA port of ``repro`` (error-controlled
progressive retrieval of scientific data under derivable QoIs).

The JAX package ``repro`` is the reference; this package mirrors its layout
module for module and never imports it (or ``jax``).  The slices ported so
far are the paper's main pipeline, for the five representations (hb, ob, ip
and the snapshot ladders psz3, psz3_delta), with the archive store, live
archives and the concurrent serve plane (``repro_torch.serve``,
``repro_torch.launch.serve``):

    archive = refactor_variables(fields, method="hb")        # Algorithm 1
    session = archive.open()
    result = retrieve_qoi_controlled(session, requests)      # Algorithms 2-4

The codec's hot loops (bitplane pack on encode, bitplane decode on
retrieval, and the serve plane's batched decode) are hand-written CUDA
kernels for Hopper (``kernels/csrc``); the entropy stage stays on the host,
as in ``repro``.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; without CUDA they raise instead of falling back.
"""
__version__ = "0.1.0"
