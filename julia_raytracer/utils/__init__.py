from julia_raytracer.utils.timing import format_seconds  # noqa: F401
