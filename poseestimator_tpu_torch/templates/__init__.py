"""Template database: CAD views rendered to point-cloud templates on disk."""
