"""Multi-rank serving data plane over the comm core (the ROADMAP's
serving tier): a front-end router rank admits an open-loop population
of synthetic sessions through persistent-request pools, worker ranks
run continuous-batching decode over a rank-sharded KV/page cache whose
pool-resident pages attach to one shared ``DynamicWindow`` and move
strictly one-sidedly (``rput`` fills, ``rget`` drains — zero
receiver-side copies, asserted via ``ProtocolStats.path_copied_bytes``).

  wire     fixed-width int64 control frames + deterministic synthetic
           tokens/pages/checksums (content is a pure function of
           (session, position, seed) — re-routable, verifiable)
  pages    PageStore (pool buffers attached to the window) and the
           allgathered PageDirectory
  router   admission, round-robin sharded placement, open-loop Poisson
           arrivals, fail-stop retirement + epoch-fenced re-routing
  worker   continuous batching, page fills/drains, raccumulate'd
           shared token stats, ``abort()`` fault hook
  service  ``ServeConfig`` + ``serve_rank`` (per-rank program) +
           ``run_serve`` (thread-runtime launcher)

The port keeps the JAX package's frames, content and copy accounting;
KV pages live on the card as uint8 tensors and cross the pool through
the ``cellcopy`` kernel (window puts, gets and local page writes). The
control frames stay in host memory. ``run_serve`` runs on the card
unless ``device="cpu"`` is passed.
"""
from repro_torch.serve.pages import PageDirectory, PageStore
from repro_torch.serve.router import Router
from repro_torch.serve.service import ServeConfig, run_serve, serve_rank
from repro_torch.serve.worker import Worker

__all__ = ["PageDirectory", "PageStore", "Router", "ServeConfig",
           "Worker", "run_serve", "serve_rank"]
