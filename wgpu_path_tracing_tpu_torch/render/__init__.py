"""render subpackage."""
