"""Per-layer metric readers: ``<metric name>.py`` each, loaded by path
(``spec.metric_module``), with ``LAYER``, ``UNIT``, ``SOURCE``, ``MOVES``,
``BETTER`` and ``read(run)``, which returns None where it finds nothing to
read."""
