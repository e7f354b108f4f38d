"""One runner a kind of traffic, named by a traffic file's ``runner`` key."""
