"""accel subpackage."""
