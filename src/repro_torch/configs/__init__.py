"""Architecture configurations the port can build (see ``registry``)."""
