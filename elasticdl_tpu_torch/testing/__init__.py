"""Test-support hooks of the port (fault injection)."""
