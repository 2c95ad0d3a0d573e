"""The notified-access kernel trio on the stacked rank axis: plain versions
(`ref`) and kernel wrappers (`ops`)."""
