"""Launchers of the port (``serve``, ``train``) and the one-card dry-run
(``specs``, ``roofline``, ``dryrun``, ``report``)."""
