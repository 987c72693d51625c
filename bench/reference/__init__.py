"""The benchmark's plain reference: imports numpy and torch only."""
