"""Perception front-end: ORB extraction, Frame, descriptor matching."""

from orbslam_in_practice.frontend.orb import ORBExtractor  # noqa: F401
from orbslam_in_practice.frontend.frame import Frame  # noqa: F401
