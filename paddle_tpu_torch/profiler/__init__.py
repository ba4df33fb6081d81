"""The health path's telemetry (counterpart: paddle_tpu/profiler/, the
parts `TrainStep(monitor_health=True)` writes to): the metrics registry
and its JSONL exporter (monitor.py), the flight recorder's rings
(flight_recorder.py) and the training-health anomaly detector
(health.py)."""
from . import flight_recorder, health, monitor
from .health import AnomalyDetector

__all__ = ["AnomalyDetector", "flight_recorder", "health", "monitor"]
