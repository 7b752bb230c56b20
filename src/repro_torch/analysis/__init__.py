"""Static analysis and the dry-run roofline of the port (the JAX
package's ``repro.analysis``).

  verify        — cross-rank verification of compiled collective
                  schedules (``core.sched``)
  lint_protocol — the shared-memory protocol linter over ``core/``
  hlo           — the roofline: H100 constants, and a dispatch-mode
                  counter of FLOPs, bytes and wire bytes in place of the
                  reference's HLO walk
"""
