"""The port's telemetry (counterpart: paddle_tpu/profiler/, the parts
the training health path and the serving path write to): the metrics
registry and its JSONL exporter (monitor.py), the flight recorder's rings
(flight_recorder.py), the training-health anomaly detector (health.py),
and the serving, fleet and memory observatories (serve_observatory.py,
fleet_observatory.py, mem_observatory.py)."""
from . import (fleet_observatory, flight_recorder, health, mem_observatory,
               monitor, serve_observatory)
from .health import AnomalyDetector

__all__ = ["AnomalyDetector", "fleet_observatory", "flight_recorder",
           "health", "mem_observatory", "monitor", "serve_observatory"]
