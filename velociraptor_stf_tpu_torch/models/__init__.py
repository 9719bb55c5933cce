"""Pipeline stages of the port: field search (``halos``), unbinding
(``unbind``), properties (``properties``) and the entry points
``search_and_unbind`` and ``find_structures`` (``pipeline``)."""
