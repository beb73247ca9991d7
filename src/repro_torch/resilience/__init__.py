"""Fault injection of the port: ``faults`` (the ``REPRO_FAULT_PLAN``
plans)."""
