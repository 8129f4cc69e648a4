"""Point-cloud geometry: camera, SE(3), padded clouds, neighbours, sampling."""
