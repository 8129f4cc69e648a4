"""The reference's template helpers on the port. ``render_lego_views`` is
the name the reference's ``main_realsense`` imports but its
``template_creation`` never defines; scripts written against it get
``render_templates``."""
import numpy as np

from ...geom3d.se3 import look_at as o3d_lookat
from ...templates.creation import (add_depth_dependent_noise, add_depth_noise,
                                   get_reduced_camera_positions, render_templates)

__all__ = ["add_depth_dependent_noise", "add_depth_noise", "get_reduced_camera_positions",
           "render_templates", "render_lego_views", "o3d_lookat", "fx_from_fov"]

render_lego_views = render_templates


def fx_from_fov(fov_deg, width):
    """Focal length in pixels of a ``width``-pixel image with horizontal
    field of view ``fov_deg``."""
    return 0.5 * width / np.tan(np.deg2rad(fov_deg) / 2.0)
