"""Operations and bytes that the algorithms need, counted from shapes."""
