"""Data sources: URI-dispatched volume readers (mem://, raw://, NRRD, lod://)."""

from libre.data.datasource import DataSource, DataSourcePlugin, register_datasource

__all__ = ["DataSource", "DataSourcePlugin", "register_datasource"]
