"""Host-side index structures (pure numpy) and device images (torch)."""
