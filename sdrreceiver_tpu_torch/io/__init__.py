"""Test-signal synthesis."""
