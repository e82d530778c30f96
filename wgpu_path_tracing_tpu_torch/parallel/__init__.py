"""parallel subpackage: multi-device rendering."""
