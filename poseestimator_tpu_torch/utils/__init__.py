"""Host-side utilities: PLY and PNG files."""
