"""Triangle-mesh rendering: the K2 raster and its face setup."""
