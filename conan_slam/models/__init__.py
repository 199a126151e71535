"""Vehicle motion and sensor models with analytic Jacobians."""
from conan_slam.models import motion, sensor  # noqa: F401
