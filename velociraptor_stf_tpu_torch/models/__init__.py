"""Pipeline stages of the port: field search (``halos``), unbinding
(``unbind``) and the search-and-unbind entry point (``pipeline``)."""
