"""Host-side utilities of the port: weight transport and tiled inference."""
