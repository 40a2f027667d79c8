"""Command-line drivers of the port (≙ reference ``nla/skylark_*.cpp``,
``ml/skylark_*.cpp``; port of ``libskylark_tpu/cli``).

Run as modules: ``python -m libskylark_tpu_torch.cli.linear FILE`` etc.
Each driver keeps the JAX package's flags, exit codes and printed lines,
and adds ``--device {cuda,cpu}`` (default ``cuda``: without a card the
run raises unless ``--device cpu`` is given); ``--telemetry`` and
``--telemetry-dir`` hold for the run only.  ``serve`` runs the serving
daemon (stdio or HTTP) over ``serve/`` and ``top`` renders a live view
of its ``/healthz``, ``/stats`` and ``/metrics`` and of the telemetry
ledgers.
"""
