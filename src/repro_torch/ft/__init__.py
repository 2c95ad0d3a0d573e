"""Fault tolerance: heartbeat and straggler detection."""
