"""Rule modules self-register with :mod:`raft_tpu_torch.analysis.engine`
on import; importing this package loads the full catalog.

How each rule of the JAX package (``raft_tpu/analysis/rules/``) maps onto
the port:

===========================  =================================================
reference rule               in the port
===========================  =================================================
``collective-discipline``    raw ``torch.distributed`` collectives and
                             broadcasts outside ``raft_tpu_torch/comms/``
                             (``collectives.py``)
``hot-path-host-transfer``   ``.item()``, ``.cpu()``, ``.tolist()``,
                             ``.numpy()``, ``np.asarray`` / ``np.array`` and
                             ``torch.cuda.synchronize`` / ``.synchronize()``
                             inside ``hotpaths.py``'s entries
                             (``host_transfer.py``)
``pallas-discipline``        ``kernel-discipline``: ``ctypes.CDLL``,
                             ``nvcc`` and ``@triton.jit`` only under
                             ``kernels/`` (``native.py`` is the host
                             runtime's home), and every ``raft_*`` symbol a
                             wrapper calls is declared in
                             ``kernels/native.py`` ``_SIGNATURES``
                             (``kernel_discipline.py``)
``probe-scan-closure``       ``torch.einsum`` / ``torch.gather`` /
                             ``take_along_dim`` over closed-over data in a
                             ``scan_probe_lists`` tile callback
                             (``probe_scan.py``)
``serve-dispatch``           no ``torch.compile``, ``torch.jit`` or direct
                             kernel-library launch in ``serve/``
                             (``serve_path.py``)
``static-arg-hashability``   unhashable literals in static positions of the
                             port's ``aot(static_argnums=...)`` programs
                             (``static_args.py``)
``dtype-drift``              ``torch.float64`` / ``torch.double`` /
                             ``np.float64`` / ``"float64"`` in library code
                             outside marked lines (``dtype_drift.py``)
``trace-impurity``           no ``print`` and no global random generator
                             (``np.random.*`` module functions,
                             ``torch.rand*`` without ``generator=``) in
                             hot-path functions (``trace_purity.py``)
``error-discipline``,        as in the reference, over the port's
``mutation-discipline``,     ``serve/``, ``comms/``, the hot paths,
``telemetry-discipline``,    ``neighbors/mutable.py`` and ``telemetry/``
``style-*``                  (``error_discipline.py``,
                             ``mutation_discipline.py``,
                             ``telemetry_discipline.py``, ``style.py``)
``raw-segment-sum``          kept (``reductions.py``): the port has a
                             keyed-reduction home, ``linalg/reduce.py``
                             (``segment_sum``, ``reduce_rows_by_key``), so
                             a raw ``index_add`` / ``scatter_add`` (or
                             ``scatter_reduce`` with ``"sum"``) elsewhere
                             is flagged; the six uses that are no keyed row
                             reduction (histograms, densifying scatters,
                             the probe counter, the sparse segment op) are
                             marked with their reason
===========================  =================================================

Dropped parts, each for its reason: ``trace-impurity``'s ``time.*``
check (an eager function reads the clock when it runs, not once at
trace time; raw clocks on hot paths stay ``telemetry-discipline``'s), the
``pallas-discipline`` VMEM-ceiling and ``BlockSpec`` checks (Pallas
constructs; a CUDA kernel's shared memory is sized in its source and
checked by its launch), and the ``x64`` comment sanction of
``dtype-drift`` (the port has no x64 switch: a float64 tensor is float64,
so each use carries the unified marker with its reason).
"""

from raft_tpu_torch.analysis.rules import (  # noqa: F401
    collectives,
    dtype_drift,
    error_discipline,
    host_transfer,
    kernel_discipline,
    mutation_discipline,
    probe_scan,
    reductions,
    serve_path,
    static_args,
    style,
    telemetry_discipline,
    trace_purity,
)

__all__ = ["collectives", "dtype_drift", "error_discipline",
           "host_transfer", "kernel_discipline", "mutation_discipline",
           "probe_scan", "reductions", "serve_path", "static_args",
           "style", "telemetry_discipline", "trace_purity"]
