"""CLI, key: token mini-language and HTTP server."""
