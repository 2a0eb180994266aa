"""Shared type aliases used across the framework."""
from __future__ import annotations

from typing import Any, Dict

PyTree = Any
Params = Dict[str, Any]
