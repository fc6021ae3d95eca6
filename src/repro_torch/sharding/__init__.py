"""Mesh sharding of the port: the reference's rules and the port's
placement on them (:mod:`.rules`), and the explicit collectives that
stand in for GSPMD's (:mod:`.comm`)."""
