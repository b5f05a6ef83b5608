"""The port's entry points a window drives, one module per index family,
named by a configuration's ``entry``.  Each gives ``prepare`` (kernel
libraries and first calls), ``build``, ``call`` (one closed-loop call),
``serve`` (an open-loop server), ``dispatches_per_call`` and ``export``
(the built index as plain tensors for the reference)."""
