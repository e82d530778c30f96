"""debug subpackage."""
