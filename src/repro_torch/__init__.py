"""repro_torch: the PyTorch/CUDA port of ``repro`` (error-controlled
progressive retrieval of scientific data under derivable QoIs).

The JAX package ``repro`` is the reference; this package mirrors its layout
module for module and never imports it (or ``jax``).  It covers the
paper's pipeline for the five representations (hb, ob, ip and the snapshot
ladders psz3, psz3_delta), the archive store, live archives, the
concurrent serve plane and the training substrate.

Subpackages:
  core / transform / bitplane / compressors   the paper
  models / configs / data                     architecture zoo + pipelines
  train / launch / serve                      trainer, CLIs, serve plane
  kernels                                     hand-written CUDA kernels

Top-level API (lazily resolved, so ``import repro_torch`` imports neither
torch nor the codec modules):

    archive = repro_torch.refactor(fields, method="hb")   # Algorithm 1
    repro_torch.save_archive(archive, "ge.prs")           # one-shot container

    a = repro_torch.open("ge.prs", repro_torch.OpenOptions.default())
    s = a.open(repro_torch.SessionOptions.memory_bounded(64 << 20))

    w = repro_torch.ArchiveWriter.create("live_dir")      # live v4 archive
    w.append({"Vx": frame}, eps=1e-3); ...; w.seal()

``repro_torch.open`` is ``repro_torch.store.open_archive``; the option
objects are the unified opener/session surface (``repro_torch.options``).
The codec's hot loops (bitplane pack on encode, bitplane decode on
retrieval, the serve plane's batched decode) are hand-written CUDA kernels
for Hopper (``kernels/csrc``); the entropy stage stays on the host, as in
``repro``.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; without CUDA they raise instead of falling back.
"""
__version__ = "0.1.0"

__all__ = [
    "open",
    "open_archive",
    "refactor",
    "ArchiveWriter",
    "ensure_archive",
    "save_archive",
    "save_sharded_archive",
    "memory_store_archive",
    "OpenOptions",
    "SessionOptions",
    "ReproDeprecationWarning",
    "StoreArchive",
    "RetrievalSession",
    "FollowStream",
    "SegmentCache",
    "RetryPolicy",
    "BlobQuarantine",
]

# name -> "module:attr"; resolved on first attribute access (PEP 562) so the
# bare package import pulls in neither torch nor the codec modules
_LAZY = {
    "open": "repro_torch.store.container:open_archive",
    "open_archive": "repro_torch.store.container:open_archive",
    "refactor": "repro_torch.core.refactor:refactor_variables",
    "ArchiveWriter": "repro_torch.store.writer:ArchiveWriter",
    "ensure_archive": "repro_torch.store.writer:ensure_archive",
    "save_archive": "repro_torch.store.container:save_archive",
    "save_sharded_archive": "repro_torch.store.container:save_sharded_archive",
    "memory_store_archive": "repro_torch.store.container:memory_store_archive",
    "OpenOptions": "repro_torch.options:OpenOptions",
    "SessionOptions": "repro_torch.options:SessionOptions",
    "ReproDeprecationWarning": "repro_torch.options:ReproDeprecationWarning",
    "StoreArchive": "repro_torch.store.container:StoreArchive",
    "RetrievalSession": "repro_torch.core.refactor:RetrievalSession",
    "FollowStream": "repro_torch.core.refactor:FollowStream",
    "SegmentCache": "repro_torch.store.cache:SegmentCache",
    "RetryPolicy": "repro_torch.store.retry:RetryPolicy",
    "BlobQuarantine": "repro_torch.store.retry:BlobQuarantine",
}


def __getattr__(name):
    target = _LAZY.get(name)
    if target is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib
    modname, attr = target.split(":")
    value = getattr(importlib.import_module(modname), attr)
    globals()[name] = value          # cache: resolve each name once
    return value


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
