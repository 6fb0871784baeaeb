"""Operator surface: command tree, HTTP endpoints, CLI.

The reference exposes operations three ways — ``vmq-admin`` (clique CLI,
``vmq_server_cli.erl``), the HTTP management API mapping REST paths onto
the same CLI commands (``vmq_http_mgmt_api.erl``), and read-only HTTP
endpoints (Prometheus ``vmq_metrics_http.erl``, ``vmq_health_http.erl``,
``vmq_status_http.erl``). This package mirrors that split: one command
registry (``commands.py``) consumed by both the CLI (``cli.py``) and the
HTTP management API (``http.py``).
"""

from .commands import CommandError, CommandRegistry, register_core_commands
from .http import HttpServer

__all__ = [
    "CommandError",
    "CommandRegistry",
    "HttpServer",
    "register_core_commands",
]
