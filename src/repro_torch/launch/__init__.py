"""Launch drivers of the port: decode cache construction and the serve CLI."""
