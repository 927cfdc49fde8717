"""Device placement of table storage."""
