"""Elastic training's liveness core — port of ``chainermn_tpu/elastic``'s
:mod:`~chainermn_tpu_torch.elastic.heartbeat` (the serving cluster's
failover detector).  The supervisor, the worker runtime and the chaos
harness are a later slice (ROADMAP A.7)."""

from .heartbeat import BeatInfo, FileBeat, HeartbeatMonitor

__all__ = ["BeatInfo", "FileBeat", "HeartbeatMonitor"]
